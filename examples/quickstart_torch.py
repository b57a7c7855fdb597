"""Quickstart on the PyTorch port (the twin of ``quickstart.py``): the
EvalNet toolchain + one training step, with ``--device cuda|cpu``
(default ``cuda``: the card, which it needs; ``cpu`` runs the plain
versions on the host).

  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.core.analysis.wavefront import resolve_device

    device = resolve_device(args.device)

    # ---- 1. generate an extreme-scale interconnect -------------------------
    from repro_torch.core import topology as T

    g = T.by_servers("slimfly", 1_000_000)       # ~1M servers, ~16k routers
    print("generated:", g.summary())

    # ---- 2. analyze it ------------------------------------------------------
    from repro_torch.core.analysis import analyze

    small = T.make("slimfly", q=17)              # exact analysis on 578 routers
    report = analyze(small, device=device)
    print("diameter:", report["diameter"], "avg path:",
          round(report["avg_path_length"], 3),
          "bisection >=", int(report["bisection_lower_bound"]))

    # ---- 3. map a training mesh onto the physical fabric --------------------
    from repro_torch.core.collectives import PhysicalFabric, plan_mesh_mapping

    plan = plan_mesh_mapping({"data": 16, "model": 16},
                             PhysicalFabric((16, 16), 1))
    print("mesh->torus assignment:", plan.assignment,
          f"(bundle {plan.score_seconds*1e3:.3f} ms)")

    # ---- 4. train a (reduced) assigned architecture one step ----------------
    from repro_torch.configs import get_config
    from repro_torch.models import steps

    steps.set_exact_gemms()
    cfg = get_config("phi3-mini-3.8b").reduced()
    state = steps.init_train_state(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    train_step = steps.make_train_step(cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                                device=device, dtype=torch.int32),
        "labels": torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                                device=device, dtype=torch.int32),
    }
    state, metrics = train_step(state, batch)
    print("one train step:", {k: round(float(v), 4) for k, v in metrics.items()})
    print("OK")


if __name__ == "__main__":
    main()
