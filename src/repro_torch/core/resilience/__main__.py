"""``python -m repro_torch.core.resilience`` -> the degradation-curve CLI."""
from .degradation import main

if __name__ == "__main__":
    raise SystemExit(main())
