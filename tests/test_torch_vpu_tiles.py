"""The generic VPU path's two tiles, without a card.

``csrc/vpu_tiles.cuh`` sizes its register-blocked tile by the algebra's
field count, of 4-byte fields, in plain C++ (``vpu_tiles::config``); here that
part is built with ``g++`` and its table held to the host's mirror
(``semiring._vpu_config``) and to the header's limits, the pick between
the large tile and the 32 x 32 tile (``semiring._vpu_tile``) is checked
around its 256-block threshold, and the generated VPU source is checked to
instantiate the tiles with the device counters. The tiles themselves run
only on the card (``chip_smoke.py`` phase 9 holds both to the plain
version and to each other, bit for bit); their arithmetic is the plain
version's, held to the JAX package in ``test_torch_semiring.py``.
"""
import shutil
import subprocess

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import semiring as S

_HARNESS = r"""
#include <cstdio>
#include "vpu_tiles.cuh"
int main() {
  for (int nf = 1; nf <= vpu_tiles::MAX_FIELDS; ++nf) {
    const vpu_tiles::Config c = vpu_tiles::config(nf);
    std::printf("%d %d %d %d %d %d %d %d %d %d\n", nf, c.bm, c.bn, c.tm, c.tn,
                c.kv, c.bv, c.bk, c.stages, c.smem);
  }
  std::printf("limits %d %d %lld %d\n", vpu_tiles::MAX_ACC,
              vpu_tiles::SMEM_MAX, vpu_tiles::LARGE_MIN_BLOCKS,
              vpu_tiles::FIELD_BYTES);
}
"""

_KEYS = ("bm", "bn", "tm", "tn", "kv", "bv", "bk", "stages", "smem")


@pytest.fixture(scope="module")
def header_table(tmp_path_factory):
    """``{nf: config dict}`` and the limits, as the header's host part
    prints them."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    work = tmp_path_factory.mktemp("vpu_tiles")
    src, exe = work / "table.cpp", work / "table"
    src.write_text(_HARNESS)
    built = subprocess.run(["g++", "-std=c++17", "-O1", "-I", str(build.CSRC),
                            "-o", str(exe), str(src)],
                           capture_output=True, text=True, timeout=120)
    assert built.returncode == 0, built.stderr
    lines = subprocess.run([str(exe)], capture_output=True, text=True,
                           timeout=60, check=True).stdout.splitlines()
    table = {}
    for line in lines[:-1]:
        nf, *values = line.split()
        table[int(nf)] = dict(zip(_KEYS, map(int, values)))
    _, *limits = lines[-1].split()
    return table, tuple(map(int, limits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32],
                         ids=["float32", "int32"])
@pytest.mark.parametrize("nf", range(1, 17))
def test_tile_configuration_follows_the_header(header_table, nf, dtype):
    """For every field count and field type: the header's configuration,
    sized for 4-byte fields, applies to the type (a VPU-path device type
    of that size), equals the host's mirror, keeps the accumulators at most
    64 registers a thread and the dynamic shared memory within two blocks
    an SM (228 KB, 1 KB reserved a block, 512 B for the static tables),
    with 2 or 3 ring stages of a K step of 32, 16 or 8. Past 12 fields
    there is none (the 32 x 32 tile runs)."""
    table, (max_acc, smem_max, min_blocks, field_bytes) = header_table
    assert (max_acc, smem_max, min_blocks, field_bytes) == (
        64, S._VPU_SMEM_MAX, S._VPU_LARGE_MIN_BLOCKS, S._VPU_FIELD_BYTES)
    assert smem_max == 113 * 1024 - 512
    assert dtype.itemsize == field_bytes and dtype in S._C_TYPES
    got = table[nf]
    want = S._vpu_config(nf)
    if nf > 12:
        assert want is None and got == dict.fromkeys(_KEYS, 0)
        return
    assert got == want
    c = want
    assert c["bm"] == 16 * c["tm"] and c["bn"] == 16 * c["tn"]
    assert c["tm"] * c["tn"] * nf <= max_acc
    assert c["bk"] in (32, 16, 8) and c["stages"] in (2, 3)
    stage = nf * (c["bm"] * (c["bk"] + 4) + c["bk"] * c["bn"]) * 4
    assert c["smem"] == c["stages"] * stage <= smem_max
    assert 2 * (c["smem"] + 512 + 1024) <= 228 * 1024
    # the deepest K step at which two stages fit, and three where they fit
    deeper = [bk for bk in (32, 16, 8) if bk > c["bk"]]
    for bk in deeper:
        assert 2 * nf * (c["bm"] * (bk + 4) + bk * c["bn"]) * 4 > smem_max
    if c["stages"] == 2:
        assert 3 * stage > smem_max
    assert c["tn"] % c["bv"] == 0 and c["bk"] % c["kv"] == 0


def test_one_field_takes_the_large_min_plus_tile():
    """One float field takes the configuration of ``tropical.cu``'s large
    min-plus tile: 128 x 128 outputs, an 8 x 8 micro-tile, float2 reads of
    A and float4 reads of B, K 32 deep through three stages, 104,448 B."""
    assert S._vpu_config(1) == dict(bm=128, bn=128, tm=8, tn=8, kv=2, bv=4,
                                    bk=32, stages=3, smem=104_448)
    assert S._vpu_config(1)["smem"] == S._minplus_smem_bytes()


@pytest.mark.parametrize("nf, batch, m, n, want", [
    # one field: 128 x 128 blocks
    (1, 12, 2048, 2048, "large"),   # the B=12 stack: 3,072 blocks
    (1, 1, 2048, 2048, "large"),    # 256 blocks, the threshold
    (1, 1, 2048, 1920, "small"),    # 240
    (1, 1, 2048, 1921, "large"),    # 256: a ragged column of blocks
    (1, 255, 128, 128, "small"),
    (1, 256, 100, 1, "large"),
    (1, 3, 300, 200, "small"),      # the ragged 300 x 200 x 260 products
    # two fields: 64 x 128 blocks
    (2, 1, 1024, 2048, "large"),    # 256
    (2, 1, 1024, 1920, "small"),    # 240
    (2, 1, 512, 512, "small"),      # TROPICAL_COUNT at p = 512: 32 blocks
    (2, 12, 2048, 2048, "large"),
    # four fields: 64 x 64 blocks
    (4, 1, 1024, 1024, "large"),    # 256
    (4, 1, 1024, 960, "small"),     # 240
    (4, 2, 1024, 1024, "large"),
    # twelve fields: 32 x 32 blocks
    (12, 1, 512, 512, "large"),     # 256
    (12, 1, 512, 480, "small"),     # 240
    # sixteen fields: no large tile, whatever the grid
    (16, 1, 256, 1024, "small"),
    (16, 1, 240, 1024, "small"),
    (16, 2, 1024, 1024, "small"),
])
def test_vpu_tile_follows_the_grid(nf, batch, m, n, want):
    """The large VPU tile runs where its grid, sized by the field count,
    has at least 256 blocks (about two per SM); the 32 x 32 tile elsewhere,
    and always past 12 fields."""
    assert S._vpu_tile(batch, m, n, nf) == want
    c = S._vpu_config(nf)
    if c is None:
        return
    blocks = batch * -(-m // c["bm"]) * -(-n // c["bn"])
    assert (blocks >= 256) == (want == "large")


def test_vpu_source_instantiates_the_vpu_tiles():
    """A generated VPU-path kernel picks its tile in ``vpu_tiles::launch``
    (``vpu_tiles.cuh``) and passes the wrapper's two device counters and
    tile argument; the 32 x 32 tile stays in ``semiring_generic.cuh``, and
    both count their launches. The host keeps a counter pair for the VPU
    path."""
    src = S.semiring_source(S.TROPICAL_COUNT, (torch.float32,))
    assert '#include "semiring_generic.cuh"' in src
    assert '#include "vpu_tiles.cuh"' in src
    assert "vpu_tiles::launch<Algebra_tropical_count>(" in src
    assert "void* counters, int tile, int batch" in src
    assert "static_cast<int*>(counters)" in src
    tiles = (build.CSRC / "vpu_tiles.cuh").read_text()
    generic = (build.CSRC / build.GENERIC_HEADER).read_text()
    assert "big_tile(" in tiles and "__launch_bounds__(THREADS, 2)" in tiles
    assert "allow_smem<" in tiles and "cp.async.wait_group" in tiles
    assert "vpu_tile(VpuArgs<Alg> p, int* counter" in generic
    assert generic.count("count_launch(counter)") == 1
    assert tiles.count("count_launch(counter)") == 1
    assert S._TILED["semiring_matmul_vpu"] == ("small", "large")
    assert S._VPU_TILE_ARG == {None: -1, "small": 0, "large": 1}
    # the MXU path is untouched: no VPU tile in its source
    mxu = S.semiring_source(S.COUNTING, (torch.float32,) * 3)
    assert "vpu_tiles" not in mxu


def test_the_mirror_follows_the_header_table():
    """``_VPU_SHAPES`` holds the micro-tile table of ``vpu_tiles::shape``:
    each row's ``Config{bm, bn, tm, tn, kv, bv, ...}`` literal is in the
    header."""
    text = (build.CSRC / "vpu_tiles.cuh").read_text()
    for _, (tm, tn, kv, bv) in S._VPU_SHAPES:
        assert f"Config{{{16 * tm}, {16 * tn}, {tm}, {tn}, {kv}, {bv}," in text


def test_rows_follow_the_picked_tile(monkeypatch):
    """The launch grid's row limit follows the tile that runs: 65,535 row
    blocks of 32 on the small tile, of the configuration's ``bm`` on the
    large one (64 rows for 4 fields). A large tile forced on an algebra of
    more than 12 fields is refused."""
    monkeypatch.setattr(S, "_use_kernel", lambda *a, **kw: True)
    monkeypatch.setattr(S, "_generated_kernel", lambda *a: pytest.fail(
        "launched past the grid"))

    def algebra(nf):
        return S.Semiring(
            name=f"w{nf}", num_fields=nf, pad_a=(0,) * nf, pad_b=(0,) * nf,
            acc_init=(0,) * nf, combine=max, kreduce=max, accumulate=max,
            cuda_combine=";", cuda_accumulate=";")

    rows = 65535 * 64 + 1
    x, y = torch.empty((rows, 1)), torch.empty((1, 64))
    with pytest.raises(ValueError, match="exceed the launch grid"):
        S.semiring_matmul(algebra(4), (x,) * 4, (y,) * 4)
    assert S._vpu_tile(1, rows, 64, 4) == "large"
    assert S._vpu_config(4)["bm"] == 64
    x = torch.empty((2, 1))
    with pytest.raises(ValueError, match="no large VPU tile for 16 fields"):
        S._semiring(algebra(16), (x,) * 16, (y,) * 16, None, True, False,
                    tile="large")


def test_an_edit_to_the_vpu_header_renames_every_library(tmp_path,
                                                         monkeypatch):
    """Every library's name, built or generated, hashes ``vpu_tiles.cuh``:
    an edit to it rebuilds each generated kernel (and every ``csrc/*.cu``
    library), checked on a temporary copy of the sources."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    types = (torch.float32,)
    keys = {S.build_key(sr, types): S.semiring_source(sr, types)
            for sr in (S.TROPICAL, S.TROPICAL_COUNT)}

    def targets():
        return ({name: build._target(name) for name in build.SOURCES}
                | {k: build.generated_target(k, src)
                   for k, src in keys.items()})

    before = targets()
    header = csrc / "vpu_tiles.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = targets()
    assert all(after[k] != before[k] for k in before)
