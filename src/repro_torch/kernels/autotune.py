"""Tile / split autotuner for the port's min-plus products.

The port of the JAX package's ``kernels/autotune.py``. The Pallas kernels
there expose (bm, bn, bk) block shapes and ``sub_k`` as free parameters;
the port's CUDA kernels have fixed tiles, and their free parameters are
the picks the host makes per call:

* ``minplus`` and ``batched_minplus`` (``csrc/tropical.cu``'s plain
  min-plus product): ``{"tile": "large" | "small", "split": 1..8}``, the
  large 128 x 128 tile or the split tile with K split over that many
  blocks of a cluster;
* ``minplus_count`` (the tropical count product, always on the split
  tile): ``{"split": 1..8}``.

Every tile and split gives the same bits (phases 3 and 8 of
``chip_smoke.py`` hold them to it), so a pick moves only time. The
counting products (``count``, ``boolean``, ``frontier_step`` and their
batched and packed forms) pick their tile on the card from the operand
(``semiring._takes_simt_tile``): they have no host-side knob, `resolve`
returns ``{}`` for them and `autotune` raises.

This module owns one small mechanism, as the JAX one does:

* a **persisted tuning table** — JSON mapping ``op -> shape bucket ->
  config``. The table shipped beside this module (``tuning_table.json``)
  is empty (the JAX package's TPU block shapes mean nothing here); a user
  table (``$REPRO_TORCH_TUNE_TABLE``, default
  ``~/.cache/repro_torch/tuning_table.json``) overlays it, so the two
  packages never read each other's entries.
* :func:`resolve` — the wrappers' hook: explicit keyword arguments always
  win, anything left unspecified comes from the table, and what the
  table does not give from the current rule (``semiring._minplus_rule``,
  the mirror of ``csrc/tropical.cu``'s ``plan``). The lookup is an
  in-process dict: no file read and no host sync a call.
* :func:`autotune` — time every candidate on the card at one shape, hold
  each bit-equal to the default pick's output, and persist the winner
  into the user table. ``python -m repro_torch.kernels.autotune --op
  minplus --size 512`` from the CLI.

Shapes are bucketed to the next power of two (min 128) per dimension, as
in the JAX package; the key has no batch, so a ``batched_minplus`` entry
tuned at one stack depth serves every depth of its bucket.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Dict, Iterable, List, Optional

__all__ = ["resolve", "autotune", "shape_key", "load_table", "save_entry",
           "DEFAULTS", "CANDIDATES"]

#: per-op knobs; None is the current rule's pick for the call's shape
DEFAULTS: Dict[str, Dict[str, Optional[object]]] = {
    "minplus": {"tile": None, "split": None},
    "batched_minplus": {"tile": None, "split": None},
    "minplus_count": {"split": None},
    "count": {},
    "boolean": {},
    "frontier_step": {},
    "batched_count": {},
    "batched_frontier_step": {},
}

_SPLITS = range(1, 9)

#: candidate grids the CLI sweeps ("large" only where the rule's grid
#: takes the large tile: the C entry forces the split tile, not the large)
CANDIDATES: Dict[str, List[Dict[str, object]]] = {
    "minplus": [{"tile": "large", "split": 1}]
    + [{"tile": "small", "split": s} for s in _SPLITS],
    "batched_minplus": [{"tile": "large", "split": 1}]
    + [{"tile": "small", "split": s} for s in _SPLITS],
    "minplus_count": [{"split": s} for s in _SPLITS],
}

#: the wrapper (and its ``tile_launches`` entry) each tuned op runs
_WRAPPER = {"minplus": "minplus_matmul",
            "batched_minplus": "batched_minplus_matmul",
            "minplus_count": "minplus_count_matmul"}

_SHIPPED = pathlib.Path(__file__).with_name("tuning_table.json")


def _user_table_path() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_TUNE_TABLE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro_torch" / "tuning_table.json"


def _read_json(path: pathlib.Path) -> Dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return {}


def shape_key(m: int, n: int, k: int, dtype: Optional[str] = None) -> str:
    """Bucket a problem shape: each dim rounds up to a power of two >= 128.

    A non-default ``dtype`` tag (e.g. ``"packed"`` for the int16/uint32
    narrow-cell kernels) is folded into the key as a ``:dtype`` suffix, so
    narrow kernels get their own tuned block shapes — their VMEM working set
    per block is smaller, which shifts the optimum. ``None``/``"f32"`` keep
    the legacy un-suffixed key, so shipped tables stay valid.
    """

    def bucket(x: int) -> int:
        b = 128
        while b < x:
            b *= 2
        return b

    key = f"{bucket(m)}x{bucket(n)}x{bucket(k)}"
    if dtype and dtype != "f32":
        key += f":{dtype}"
    return key


_TABLE_CACHE: Optional[Dict] = None


def load_table(refresh: bool = False) -> Dict[str, Dict[str, Dict]]:
    """Shipped table overlaid with the user table (user entries win).

    Cached in-process (the wrappers consult it on every call); refreshed
    after :func:`save_entry` or on ``refresh=True``.
    """
    global _TABLE_CACHE
    if _TABLE_CACHE is None or refresh:
        table = _read_json(_SHIPPED)
        for op, entries in _read_json(_user_table_path()).items():
            table.setdefault(op, {}).update(entries)
        _TABLE_CACHE = table
    return _TABLE_CACHE


def save_entry(op: str, key: str, config: Dict) -> pathlib.Path:
    """Persist one tuned entry into the user table."""
    global _TABLE_CACHE
    path = _user_table_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    table = _read_json(path)
    table.setdefault(op, {})[key] = dict(config)
    path.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    _TABLE_CACHE = None
    return path


_DECISIONS_SEEN: set = set()


def _note_decision(op: str, key: str, cfg: Dict, tuned, overrides) -> None:
    """Under an enabled tracer, record which table entry won ``resolve``
    and why — once per (op, shape bucket) so the hot path stays hot."""
    from .. import obs

    if not obs.enabled() or (op, key) in _DECISIONS_SEEN:
        return
    _DECISIONS_SEEN.add((op, key))
    source = {kk: ("override" if kk in overrides
                   and overrides[kk] is not None
                   else "tuned" if tuned and kk in tuned else "default")
              for kk in cfg}
    obs.instant("autotune.resolve", cat="kernels", op=op, shape=key,
                config=dict(cfg), source=source,
                tuned_entry=dict(tuned) if tuned else None)


def _rule(op: str, batch: int, m: int, n: int, k: int) -> Dict:
    """The current rule's pick (``csrc/tropical.cu``'s ``plan``)."""
    from .semiring import _minplus_rule

    tile, split = _minplus_rule(batch, m, n, k,
                                2 if op == "minplus_count" else 1)
    return {"tile": tile, "split": split}


def _launchable(op: str, batch: int, m: int, n: int, cfg: Dict) -> bool:
    """Whether the C entry can run ``cfg``: the large tile only where the
    rule's grid takes it (the entry forces the split tile only), a split
    of 1..8 whose grid (batch x split clusters) fits ``gridDim.z``."""
    from .semiring import _MAX_BATCH, _MINPLUS_SPLIT_MAX, _minplus_tile

    if cfg.get("tile") == "large":
        return op != "minplus_count" and _minplus_tile(batch, m, n) == "large"
    split = cfg.get("split")
    return (isinstance(split, int) and 1 <= split <= _MINPLUS_SPLIT_MAX
            and batch * split <= _MAX_BATCH)


def resolve(op: str, m: int, n: int, k: int, dtype: Optional[str] = None,
            batch: int = 1, **overrides) -> Dict:
    """Final config for one op call: overrides > tuned table > the current
    rule (``semiring._minplus_rule``).

    Only the knobs of the op's default config are returned (``{}`` for an
    op whose tile the card picks). A split forced without a tile means the
    split tile. A pick the C entry cannot run at this shape (the large
    tile on a grid the rule gives the split tile; a split past 8 or past
    ``gridDim.z``) falls back to the rule's pick. ``dtype`` keys the
    lookup (see :func:`shape_key`). Under an enabled `repro_torch.obs`
    tracer the decision (winning entry + per-knob source) is emitted as an
    ``autotune.resolve`` instant event, once per (op, key).
    """
    if op not in DEFAULTS:
        raise ValueError(f"unknown autotune op {op!r}")
    cfg = dict(DEFAULTS[op])
    if not cfg:
        return {}
    key = shape_key(m, n, k, dtype)
    tuned = load_table().get(op, {}).get(key)
    if tuned:
        cfg.update({kk: vv for kk, vv in tuned.items() if kk in cfg})
    given = {kk: vv for kk, vv in overrides.items()
             if kk in cfg and vv is not None}
    if "split" in given and "tile" in cfg and "tile" not in given:
        given["tile"] = "small"
    cfg.update(given)
    rule = _rule(op, batch, m, n, k)
    if cfg.get("tile") == "large":
        cfg["split"] = 1
    for kk in cfg:
        if cfg[kk] is None:
            cfg[kk] = rule[kk]
    if not _launchable(op, batch, m, n, cfg):
        cfg = {kk: rule[kk] for kk in cfg}
    _note_decision(op, key, cfg, tuned, overrides)
    return cfg


def _median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event times of ``fn()`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


def _bit_equal(x, y) -> bool:
    """NaN where ``y`` is NaN, and the same bits everywhere else."""
    import torch

    nan = torch.isnan(y)
    return bool(torch.equal(torch.isnan(x), nan) and torch.equal(
        x.masked_fill(nan, 0.0).view(torch.int32),
        y.masked_fill(nan, 0.0).view(torch.int32)))


def _label(cfg: Dict) -> str:
    return "/".join(f"{kk}={vv}" for kk, vv in sorted(cfg.items()))


def autotune(op: str, size: int, batch: int = 0,
             candidates: Optional[Iterable[Dict]] = None,
             persist: bool = True, dtype: Optional[str] = None,
             device="cuda", reps: int = 7) -> Dict:
    """Time candidate configs for ``op`` at a square (size, size) problem
    (optionally stacked ``batch`` deep) on the card and persist the winner.

    Each candidate runs once to warm up, then ``reps`` (at least 5) times
    between CUDA events; its median is its time. Every candidate's output
    must equal the default pick's (the rule's) bit for bit, NaN for NaN:
    one that differs raises. A candidate the C entry cannot run at this
    shape (see :func:`resolve`) is left out and listed under ``skipped``.
    Returns the winner with ``key``, ``seconds``, every candidate's
    ``times`` (ms), the ``default`` pick and its ``default_ms``.

    Raises ``ValueError`` for an op whose tile the card picks from the
    operand (it has no host-side knob), for ``dtype="packed"`` (the packed
    steps are such ops) and for a CPU ``device`` (the plain versions have
    no tile); ``RuntimeError`` without a card.
    """
    import numpy as np
    import torch

    from ..core.analysis.wavefront import resolve_device
    from . import ops

    if (op in DEFAULTS and not DEFAULTS[op]) or dtype == "packed":
        raise ValueError(
            f"{op!r} has no host-side tile pick: its kernel picks its tile "
            f"on the card from the operand (semiring._takes_simt_tile), so "
            f"there is nothing to tune")
    if op not in CANDIDATES:
        raise ValueError(f"unknown autotune op {op!r}")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"autotune times the CUDA kernels; the plain "
                         f"versions on {dev} have no tile")
    if reps < 5:
        raise ValueError(f"reps {reps}: the median needs at least 5")
    if (op == "batched_minplus") != bool(batch):
        raise ValueError(f"{op}: batch {batch} (batched_minplus tunes a "
                         f"stack of batch >= 1, the others a 2D product)")

    rng = np.random.default_rng(0)
    shape = (batch, size, size) if batch else (size, size)
    mask = rng.random(shape) < 0.05
    a = torch.from_numpy(mask.astype(np.float32)).to(dev)
    d = torch.from_numpy(np.where(np.eye(size, dtype=bool), 0.0,
                                  np.inf).astype(np.float32)).to(dev)
    runners = {
        "minplus": lambda cfg: ops.minplus_matmul(a, a, **cfg),
        "batched_minplus":
            lambda cfg: ops.batched_minplus_matmul(a, a, **cfg),
        "minplus_count":
            lambda cfg: ops.minplus_count_matmul(d, a, d, a, **cfg),
    }
    run = runners[op]
    lead = batch or 1
    default = _rule(op, lead, size, size, size)
    default = {kk: default[kk] for kk in DEFAULTS[op]}
    want = run(default)
    want = want if isinstance(want, tuple) else (want,)
    cands = list(candidates if candidates is not None else CANDIDATES[op])
    times, skipped = {}, []
    best_cfg, best_ms = None, float("inf")
    for cand in cands:
        cfg = {kk: vv for kk, vv in cand.items() if kk in DEFAULTS[op]}
        if not _launchable(op, lead, size, size, cfg):
            skipped.append(_label(cfg))
            continue
        got = run(cfg)
        got = got if isinstance(got, tuple) else (got,)
        if not all(map(_bit_equal, got, want)):
            raise RuntimeError(f"autotune {op} at {shape}: {cfg} differs "
                                   f"from the default pick {default}")
        ms = _median_ms(lambda c=cfg: run(c), reps)
        times[_label(cfg)] = ms
        if ms < best_ms:
            best_cfg, best_ms = cfg, ms
    if best_cfg is None:
        raise RuntimeError(f"no candidate config ran for {op} at {size}")
    key = shape_key(shape[-2], shape[-1], shape[-1], dtype)
    if persist:
        save_entry(op, key, best_cfg)
    from .semiring import _minplus_column

    column = _minplus_column(best_cfg.get("tile", "small"), best_cfg["split"])
    return dict(best_cfg, key=key, seconds=best_ms / 1e3, times=times,
                skipped=skipped, default=default,
                default_ms=times.get(_label(default)),
                column=(_WRAPPER[op], column))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", default="minplus",
                    help=f"one of {sorted(CANDIDATES)}")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--dtype", default=None, choices=(None, "f32", "packed"),
                    help="cell dtype to tune (packed = int16/uint32 cells)")
    ap.add_argument("--no-persist", action="store_true")
    args = ap.parse_args(argv)
    res = autotune(args.op, args.size, batch=args.batch, dtype=args.dtype,
                   persist=not args.no_persist)
    times = res.pop("times")
    print(f"[autotune] {args.op} @ {res.pop('key')}: best {res}")
    for label, ms in times.items():
        print(f"  {label}: {ms:.4f} ms")
    if not args.no_persist:
        print(f"[autotune] persisted to {_user_table_path()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
