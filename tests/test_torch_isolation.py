"""The port stands alone: no module of seaweedfs_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib, msgpack or the JAX package
seaweedfs_tpu (exact module names: seaweedfs_tpu_torch itself merely
starts with the same letters), and a process that refuses those imports
(and triton, with no nvcc on its PATH) runs an encode, a rebuild, a
degraded read, a Volume.bulk_lookup, an EcVolume.bulk_locate and one gate
flush through the arena of the port, building no kernel."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "seaweedfs_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "msgpack", "seaweedfs_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources() -> list:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_forbidden_matches_exact_names_only():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert _forbidden("seaweedfs_tpu") and _forbidden("seaweedfs_tpu.ops.gf256")
    assert _forbidden("msgpack") and not _forbidden("msgpack_lite")
    assert not _forbidden("seaweedfs_tpu_torch")
    assert not _forbidden("seaweedfs_tpu_torch.ops.gf256")
    assert not _forbidden("jaxtyping")


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_forbidden_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the port
                continue
            names = [node.module or ""]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", ""))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, REPO)}:{node.lineno} imports {bad}"


_SCRIPT = textwrap.dedent(
    """
    import importlib.abc, os, sys, tempfile

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == f or name.startswith(f + ".")
                   for f in ("jax", "jaxlib", "msgpack", "seaweedfs_tpu",
                             "triton")):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    from seaweedfs_tpu_torch.ops.rs_kernel import CudaRSCodec
    from seaweedfs_tpu_torch.storage import idx
    from seaweedfs_tpu_torch.storage.erasure_coding import (
        EcVolume, rebuild_ec_files, to_ext, write_ec_files,
        write_sorted_file_from_idx)
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.super_block import SuperBlock
    from seaweedfs_tpu_torch.types import to_offset_units

    d = tempfile.mkdtemp(dir=sys.argv[1])
    base = os.path.join(d, "5")
    rng = np.random.default_rng(5)
    want = {}
    with open(base + ".dat", "wb") as dat, open(base + ".idx", "wb") as ix:
        dat.write(SuperBlock().to_bytes())
        # 74 needles: 8 large rows + 5 small, clear of the reference's
        # row-count window (locate.py: locate_data)
        for nid in range(1, 75):
            n = Needle(cookie=nid, id=nid,
                       data=rng.integers(0, 256, int(rng.integers(1, 9000)),
                                         dtype=np.uint8).tobytes())
            blob, _, _ = n.to_bytes(3)
            ix.write(idx.entry_to_bytes(nid, to_offset_units(dat.tell()), n.size))
            dat.write(blob)
            want[nid] = (n.data, n.checksum)
    codec = CudaRSCodec(device="cpu")
    write_ec_files(base, codec=codec, large_block_size=4096,
                   small_block_size=512, chunk=1000)
    write_sorted_file_from_idx(base)
    shards = [open(base + to_ext(i), "rb").read() for i in range(14)]
    for i in (0, 4, 10, 13):
        os.remove(base + to_ext(i))
    with EcVolume(d, "", 5, 4096, 512) as ev:
        for nid, (data, crc) in want.items():
            n = ev.read_needle(nid, codec)
            assert (bytes(n.data), n.checksum) == (data, crc), nid
    assert rebuild_ec_files(base, codec=codec, chunk=700) == [0, 4, 10, 13]
    assert [open(base + to_ext(i), "rb").read() for i in range(14)] == shards

    # the needle-index slice: bulk_locate, a volume's bulk_lookup over
    # both maps, and one gate flush answered by the arena
    import asyncio
    from seaweedfs_tpu_torch.ops import index_kernel, ragged_lookup
    from seaweedfs_tpu_torch.server.lookup_gate import BatchLookupGate
    from seaweedfs_tpu_torch.storage.volume import Volume
    ids = np.asarray(sorted(want) + [999], dtype=np.uint64)
    with EcVolume(d, "", 5, 4096, 512, device="cpu") as ev:
        assert ev.bulk_locate(ids)[2].tolist() == [True] * 74 + [False]
    vols = {}
    for vid, kind in ((6, "memory"), (7, "lsm")):
        v = vols[vid] = Volume(d, "", vid, needle_map_kind=kind, device="cpu")
        for nid in range(1, 300):
            v.write_needle(Needle(cookie=1, id=nid, data=b"x" * (nid % 7)))
        v.delete_needle(Needle(cookie=1, id=3))
        found = v.bulk_lookup(np.arange(1, 400, dtype=np.uint64))[2]
        assert found.sum() == 298 and not found[2], kind
    vols[7].nm.save_snapshot()  # seal the memtable into a run
    class Store:
        def find_volume(self, vid):
            return vols.get(vid)
    arena = ragged_lookup.DeviceColumnArena(device="cpu")
    arena.ensure(vols[7].nm.arena_view([])[1])
    arena.refresh_sync()
    gate = BatchLookupGate(Store(), arena=arena, identity_check=True)
    async def flush():
        return await asyncio.gather(*(gate.lookup(7, k) for k in range(1, 301)))
    res = asyncio.run(flush())
    assert sum(r is not None for r in res) == 298 and res[2] is None
    assert gate.stats["device_probes"] == 300, gate.stats
    assert gate.stats["identity_mismatches"] == 0
    assert index_kernel._LIB is None and ragged_lookup._LIB is None
    arena.close()
    for v in vols.values():
        v.close()
    loaded = [m for m in sys.modules
              if any(m == f or m.startswith(f + ".")
                     for f in ("jax", "jaxlib", "msgpack", "seaweedfs_tpu",
                               "triton"))]
    assert not loaded, loaded
    print("ISOLATED-OK")
    """
)


def test_port_runs_with_jax_imports_refused(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_HOME")}
    env["PYTHONPATH"] = REPO
    env["PATH"] = "/usr/bin:/bin"  # no nvcc
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(tmp_path)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ISOLATED-OK" in proc.stdout
