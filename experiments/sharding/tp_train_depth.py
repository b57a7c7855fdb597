"""Tell bf16 noise from a fault in gemma-2b's tensor-parallel gradient blocks
(``chip_smoke.py``'s 19b) at a cut depth.

19b holds layer 0's and the embedding's gradient blocks of the
tensor-parallel form within 2^-4 of max |g| of the form that gathers every
layer whole, both in bf16. This runs 19b on the same four gloo ranks sharing
one card, cut to ``--layers`` of gemma-2b's 18, with the gather-whole form
also run in float32 (19c's rule): each bf16 form's relative L2 distance from
it, leaf by leaf. A tensor-parallel block much farther from the float32 form
than the bf16 gather-whole form's is a fault; two alike are bf16 noise.

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 experiments/sharding/tp_train_depth.py --layers 9
"""
import argparse
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=9)
    args = ap.parse_args()
    from repro_torch.core.analysis import distributed as D

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    spec = dict(C.TP_TRAIN_FULL, n_layers=args.layers, f32_oracle=True)
    sizes = dict(C.SHARD_SIZES, parts=("19b",), tp_train_full=spec)
    no_exchange = ({p: {} for p in range(2)}, {p: {} for p in range(2)})
    _, _, ranks = D.launch_mesh(C.sharding_rank, C.SHARD_RANKS, no_exchange,
                                sizes, None, device="cuda", timeout_s=900)
    print(f"gemma-2b at {args.layers} of 18 layers on (data, model) = "
          f"{spec['mesh']}, {spec['batch']} x {spec['seq']} tokens ({smi})")
    for rec in ranks:
        r = rec["19b"]
        print(f"  rank {rec['rank']}: loss tp {r['tp']['loss']:.6g}, whole "
              f"{r['whole']['loss']:.6g}, float32 {r['f32']['loss']:.6g}; "
              f"gradient norm tp {r['tp']['gnorm']:.6g}, whole "
              f"{r['whole']['gnorm']:.6g}, float32 {r['f32']['gnorm']:.6g}")
        for path, gap in r["gaps"].items():
            tp, whole = r["f32_dist"][path]
            print(f"    {path}: tp against whole {gap:.4g} of max |g| "
                  f"(19b's limit {C.BF16_TOL}); relative L2 from float32: "
                  f"tp {tp:.4g}, whole {whole:.4g}")
    fails = C._tp_train_full_report("19b", spec, ranks)
    print("held by the float32 form:", "; ".join(fails) if fails else "yes")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
