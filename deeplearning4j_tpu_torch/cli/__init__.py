"""Command-line interface of the port: the ``serve`` subcommand (port of
``deeplearning4j_tpu/cli``; ``train``, ``test``, ``predict`` and
``fleet`` are not ported yet)."""

from deeplearning4j_tpu_torch.cli.driver import main

__all__ = ["main"]
