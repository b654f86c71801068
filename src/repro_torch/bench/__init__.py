"""The port's benchmarks: the paper's behavioural suite (``behavioral``)."""
