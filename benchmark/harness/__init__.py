"""The yardstick's shared pieces: the run's environment and clocks, the
scenes the cells are made of, the published peaks and the work counts
that rooflines are taken against, the reduction of the profiler's trace,
and the comparison that decides ``correct``."""
