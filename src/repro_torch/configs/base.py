"""Architecture + shape configuration system.

Every assigned architecture is a ``ArchConfig`` registered under its id.
``reduced()`` returns a tiny same-family config for CPU tests; a full
config runs on the card (``chip_smoke.py`` phase ``lm`` serves
qwen2.5-3b at full width).  A copy of the JAX package's
``src/repro/configs/base.py``: the same fields, defaults and arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "register", "get_config",
           "list_archs", "MoEConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int            # per-expert FFN hidden size
    capacity_factor: float = 1.25
    expert_parallel: bool = True   # shard expert dim over 'model' (else TP inside experts)
    # routing group size (tokens). The GShard dispatch/combine einsums cost
    # O(tokens * E * C * d) with C = group * top_k / E * cf — i.e. quadratic
    # in the group length. Groups of ~512 keep dispatch overhead ~25% of the
    # expert matmul flops instead of >200% at group = 4096 (§Perf P2).
    group_size: int = 512


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                # dense FFN hidden (0 = no FFN, e.g. xLSTM)
    vocab: int
    # options
    qkv_bias: bool = False
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    moe: MoEConfig | None = None
    ssm_state: int = 0       # Mamba2 state size (hybrid / ssm archs)
    # hybrid/ssm block pattern: callable layer_idx -> block kind
    #   'attn' | 'mamba2' | 'mlstm' | 'slstm'
    block_pattern: str = "attn"       # attn | xlstm | zamba
    # enc-dec (whisper): n_layers applies to BOTH encoder and decoder
    is_encdec: bool = False
    n_audio_frames: int = 1500        # whisper encoder frames (conv stub output)
    # modality frontend stub: None | 'audio' | 'image'
    frontend: str | None = None
    sub_quadratic: bool = False       # True => runs long_500k
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # chunking (memory/perf levers; 0 = full-sequence single tile, used by
    # the dry-run's exact-cost shallow compiles)
    attn_chunk_q: int = 512
    attn_chunk_k: int = 1024
    ssm_chunk: int = 64
    # unroll the layer scan (dry-run cost variants only: cost_analysis
    # counts a rolled scan body once regardless of trip count)
    layer_unroll: bool = False
    # distribution strategy over the fixed production mesh:
    #   'tp' — tensor parallel over `model`, DP+FSDP over `data` (default)
    #   'dp' — pure data parallel over data x model with ZeRO-3 parameter
    #          sharding (per-layer weight all-gathers). Wins for models too
    #          small to amortise TP activation collectives (§Perf).
    shard_strategy: str = "tp"
    # distribution
    vocab_align: int = 2048           # pad vocab so the TP head shards evenly
    remat: bool = True
    # remat granularity: 'full' (recompute whole block), 'dots' (save dot
    # outputs, recompute elementwise), 'none' (no remat — when the sharding
    # strategy leaves HBM headroom, §Perf P1 it.3)
    remat_policy: str = "full"

    # ------------------------------------------------------------------ #
    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        a = self.vocab_align
        return -(-self.vocab // a) * a

    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def block_kind(self, layer: int) -> str:
        if self.block_pattern == "attn":
            return "attn"
        if self.block_pattern == "xlstm":
            # xLSTM[7:1]-style: every 8th block is sLSTM, rest mLSTM
            return "slstm" if layer % 8 == 7 else "mlstm"
        if self.block_pattern == "zamba":
            # Zamba2: Mamba2 backbone with a shared attention block applied
            # every 6 layers (shared weights — the Zamba trick)
            return "attn_shared" if layer % 6 == 5 else "mamba2"
        raise ValueError(self.block_pattern)

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_padded
        kv = self.n_kv_heads * self.d_head
        n = V * d * (1 if self.tie_embeddings else 2)
        if self.is_encdec:
            L = 2 * self.n_layers
        for i in range(L):
            kind = self.block_kind(i % self.n_layers)
            if kind in ("attn", "attn_shared"):
                n += d * (d + 2 * kv) + d * d          # qkv + o
            elif kind == "mamba2":
                d_in = 2 * d
                n += d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            elif kind in ("mlstm", "slstm"):
                dp = 2 * d
                n += 3 * d * dp + dp * d               # qkv + down
            if self.moe is not None:
                n += self.moe.n_experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
            elif self.d_ff:
                n += 3 * d * self.d_ff                  # swiglu
        if self.is_encdec:
            n += self.n_layers * 2 * d * (d + kv)       # cross-attn extra
        return n

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        moe_all = self.n_layers * self.moe.n_experts * 3 * self.d_model * self.moe.d_expert
        moe_act = self.n_layers * self.moe.top_k * 3 * self.d_model * self.moe.d_expert
        return full - moe_all + moe_act

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                n_experts=min(self.moe.n_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_expert=64)
        small_heads = max(2, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, small_heads))
        while small_heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=max(2, min(self.n_layers, 8) // 2) if self.block_pattern == "attn"
            else 8,  # keep pattern periodicity visible for hybrids
            d_model=128,
            n_heads=small_heads,
            n_kv_heads=kv,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=512,
            vocab_align=128,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            n_audio_frames=32,
            moe=moe,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    import importlib
    if name not in _REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    # import all config modules
    import importlib
    import pkgutil

    import repro_torch.configs as pkg
    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name not in ("base", "__init__"):
            importlib.import_module(f"repro_torch.configs.{m.name}")
    return sorted(_REGISTRY)
