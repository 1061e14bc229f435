"""The port of ``examples/``: each script has ``main(argv=None)`` with the
JAX script's flags plus ``--device`` (default: the card), runs as
``python -m kaolin_tpu_torch.examples.<name>``, prints the JAX script's
final line and returns its last result as a tensor."""
