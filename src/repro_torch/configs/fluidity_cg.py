"""The paper's own benchmark configuration: Fluidity pressure-solve matrices
on the hybrid (node x core) mesh.  Sizes mirror Sec. 3/4 of the paper:
the Fig. 3 matrix has 13.5M DoF / 371M nnz; Fig. 4 has 52M DoF / 1.46B nnz.
CPU-runnable scaled-down versions are provided for measurement."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CGConfig:
    name: str
    n_surface: int          # 2-D coastline points
    layers: int             # vertical extrusion (workload scaling knob)
    seed: int = 0
    tol: float = 1e-8
    maxiter: int = 10_000   # paper Sec. 3
    mode: str = "balanced"

    @property
    def approx_dof(self) -> int:
        return self.n_surface * self.layers


# paper-scale matrices (dry-run / modelled benchmarks only)
PAPER_SMALL = CGConfig("fig3-13.5M", n_surface=210_000, layers=64)
PAPER_LARGE = CGConfig("fig4-52M", n_surface=210_000, layers=256)
# CPU-measurable versions
BENCH_SMALL = CGConfig("bench-small", n_surface=2_000, layers=16)
BENCH_LARGE = CGConfig("bench-large", n_surface=2_000, layers=64)
