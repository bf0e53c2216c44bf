"""``python -m deeplearning4j_tpu_torch.cli`` entry point."""

from deeplearning4j_tpu_torch.cli.driver import main

if __name__ == "__main__":
    raise SystemExit(main())
