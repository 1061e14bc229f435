"""One driver per configuration family, named by the configuration's
``driver`` key: ``run(ctx)`` drives the program through one cell."""
