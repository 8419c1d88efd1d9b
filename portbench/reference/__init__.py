"""The plain reference that judges a run: BFV tuples and their public
instance (``bfv``), and a frozen python-int copy of the port's verifier
(``verifier`` with ``transcript``, ``protocol``, ``pairing``, ``bn254``).
It imports neither torch, JAX, the JAX package nor anything of the port."""
