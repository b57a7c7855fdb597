"""Perf hillclimbing driver (§Perf): re-traces a cell with a named
optimization applied and records the tagged before/after dry-run artifact.

The port of the JAX package's ``launch/hillclimb.py``: the same registry,
each entry through the port's `dryrun.run_cell` (one rank's step traced on
meta tensors in a fake process group; records under
``experiments/dryrun/torch/``). One documented difference: ``gradcomp``
runs here (the port's ``steps.make_compressed_train_step``), where the
JAX package's compressed step fails to lower under jax 0.9 and XLA's
partial-manual ``shard_map``, so the port's record is ``ok`` where the JAX
record is a failure.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --exp int8kv
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --all
"""
import argparse

from .dryrun import run_cell

# experiment registry: (arch, shape, multi_pod, overrides, tag)
EXPERIMENTS = {
    # H1: worst-memory cell — qwen decode holds a 5.5 TB bf16 KV cache
    # (kv=40 full-MHA heads). int8 KV (KIVI-style per-token scales) halves
    # cache bytes AND the memory roofline term.
    "int8kv": ("qwen1.5-32b", "decode_32k", False,
               {"kv_cache_dtype": "int8"}, "+int8kv"),
    # H1b: same treatment for the phi3 decode cell (memory-dominant).
    "int8kv_phi3": ("phi3-mini-3.8b", "decode_32k", False,
                    {"kv_cache_dtype": "int8"}, "+int8kv"),
    # H2: most collective-bound cell — jamba decode. Iteration 1: distributed
    # flash-decode (shard_map partial softmax + LSE merge) keeps cache reads
    # local. Iteration 2 (after i1 showed the wire is FSDP weight gathers,
    # 10.3 GB/token): weight-stationary serving — replicate the ~2 MB/layer
    # activation stream over `data`, never gather weights.
    "flashdecode": ("jamba-1.5-large-398b", "decode_32k", False,
                    {"decode_attention": "sharded"}, "+flashdecode"),
    "flashdecode_long": ("jamba-1.5-large-398b", "long_500k", False,
                         {"decode_attention": "sharded"}, "+flashdecode"),
    "wstationary": ("jamba-1.5-large-398b", "decode_32k", False,
                    {"decode_attention": "sharded",
                     "replicate_decode_stream": True}, "+wstationary"),
    "wstationary_long": ("jamba-1.5-large-398b", "long_500k", False,
                         {"decode_attention": "sharded",
                          "replicate_decode_stream": True}, "+wstationary"),
    # H3: multi-pod DCN-bound train cell. Iteration 1: int8 error-feedback
    # gradient compression over the pod axis (shard_map manual-pod) — XLA
    # 0.8's SPMD partitioner CHECK-fails on partial-manual + inner auto
    # sharding; numerics validated in tests, compile blocked (recorded).
    "gradcomp": ("phi3-mini-3.8b", "train_4k", True,
                 {"grad_compression": "int8_pod"}, "+gradcomp"),
    # Iteration 2: FSDP over (pod, data): cross-pod sync becomes
    # reduce-scatter + bf16 all-gather instead of f32 all-reduce.
    "podfsdp": ("phi3-mini-3.8b", "train_4k", True,
                {"fsdp": "pod_data"}, "+podfsdp"),
    # beyond-paper: remat policy (save dots, less recompute) on the most
    # compute-bound train cell
    "rematdots": ("qwen1.5-32b", "train_4k", False,
                  {"remat": "dots"}, "+rematdots"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    names = list(EXPERIMENTS) if args.all else [args.exp]
    for name in names:
        arch, shape, multi, overrides, tag = EXPERIMENTS[name]
        print(f"=== hillclimb {name}: {arch} {shape} "
              f"{'2x16x16' if multi else '16x16'} {overrides} ===")
        rec = run_cell(arch, shape, multi, overrides=overrides, tag=tag)
        if rec["status"] != "ok":
            print("  ", rec)
            continue
        r = rec["roofline"]
        print(f"  mem={rec['memory']['per_device_total_gb']:.2f}GB "
              f"compute={r['compute_s']*1e3:.2f}ms "
              f"hbm={r['memory_s']*1e3:.2f}ms "
              f"coll={r['collective_flat_s']*1e3:.2f}ms "
              f"dom={r['dominant']} wire={r['collective_wire_bytes']/1e9:.2f}GB")


if __name__ == "__main__":
    main()
