"""The paper's figure harness on the port (``bench.common``,
``bench.figures``): CPU-scale instances of the paper's experiments on the
tree-state driver, on the card unless the caller asks for the CPU."""
