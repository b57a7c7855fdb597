"""Batched serving demo on the PyTorch port: continuous batching over a
reduced gemma config (the twin of ``serve_demo.py``).

  PYTHONPATH=src python examples/serve_demo_torch.py               # the card
  PYTHONPATH=src python examples/serve_demo_torch.py --device cpu
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
