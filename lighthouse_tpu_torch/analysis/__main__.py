"""`python -m lighthouse_tpu_torch.analysis <paths>` — run the beacon-san lint."""

from .lint import main

if __name__ == "__main__":
    raise SystemExit(main())
