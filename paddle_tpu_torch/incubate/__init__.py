"""The parts of the JAX package's ``incubate`` that the port has: the
mixture-of-experts layer of the GPT-MoE blocks."""
