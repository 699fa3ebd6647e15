"""The language-model code of the port, on its serving path: the attention
families (dense, GQA, MoE, VLM, enc-dec) of ``repro_torch.configs``, from
init to prefill and decode.  The recurrent families (xLSTM, Zamba) are not
ported yet and raise ``NotImplementedError``."""
