"""The PyTorch port's counterpart of ``examples/serve_lm.py``: the seed
LM decode loop that example drove is retired, and its slot/refill idiom
lives on in ``repro_torch.serve.engine``, which serves the solver stack
with continuous multi-RHS batching.  This example drives that engine
through the port's serving CLI with the reference's arguments; extra
arguments pass through (``--device cpu`` runs it on the CPU):

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import sys

from repro_torch.launch.serve import main as serve_main

if __name__ == "__main__":
    sys.exit(serve_main([
        "--n-node", "1", "--n-core", "2",
        "--requests", "8", "--nrhs", "4",
        "--tol-spread", "--oracle",
        *sys.argv[1:],
    ]))
