"""The language-model code of the port, on its serving path: every family
of ``repro_torch.configs`` (dense, GQA, MoE, VLM, enc-dec, and the
recurrent xLSTM and Zamba stacks), from init to prefill and decode."""
