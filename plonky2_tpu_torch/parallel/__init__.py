"""Multi-device proving: the prover mesh (context.py) and the six-step
NTT and sharded Merkle cap over it (ntt.py)."""
