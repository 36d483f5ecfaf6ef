"""The volume server's small modules against the JAX package's: file ids,
Range parsing, multipart parsing, response rendering, the JWT guard
and the RPC port convention. The same inputs (seeded) must give the
same outputs. Tolerance: exact."""

import random

import pytest

from seaweedfs_tpu import pb as jax_pb
from seaweedfs_tpu.storage.file_id import FileId as JaxFileId
from seaweedfs_tpu.util import fasthttp as jax_fasthttp
from seaweedfs_tpu.util import http_range as jax_http_range
from seaweedfs_tpu.util import security as jax_security
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.storage.file_id import FileId
from seaweedfs_tpu_torch.util import fasthttp, http_range, security


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return (type(e).__name__, str(e))


FIDS = ["3,01637037d6", "3,0144b9f3d1_2", "7,ffffffffffffffff00000001",
        "0,1234567890", "3,zz", "3", ",0144b9f3d1", "3,01", "12,0a_x",
        "4,ffffffffffffffff00000001_1"]


@pytest.mark.parametrize("fid", FIDS)
def test_file_id_parse_and_format_equal_jax(fid):
    got, want = _outcome(FileId.parse, fid), _outcome(JaxFileId.parse, fid)
    assert got[0] == want[0]
    if got[0] == "ok":
        assert (got[1].volume_id, got[1].key, got[1].cookie) == (
            want[1].volume_id, want[1].key, want[1].cookie)
        assert str(got[1]) == str(want[1])
    else:
        assert got == want


RANGES = ["bytes=0-9", "bytes=-5", "bytes=5-", "bytes=100-", "bytes=a-b",
          "bytes=0-1,3-4", "bytes=-0", "bytes=9-3", "items=0-3", "",
          "bytes=0-", "bytes=-100", "bytes= 2-4", "bytes=2-4 ", "bytes=--1"]


@pytest.mark.parametrize("total", [0, 1, 10, 100])
def test_parse_range_equals_jax(total):
    for rng in RANGES:
        assert http_range.parse_range(rng, total) == jax_http_range.parse_range(
            rng, total), rng


def test_multipart_and_render_equal_jax():
    rng = random.Random(4)
    for i in range(40):
        data = rng.randbytes(rng.randint(0, 300))
        name = rng.choice(["file", "upload", "other"])
        mime = rng.choice(["", "text/x"])
        body, ct = fasthttp.build_multipart(
            name, data, filename=f"n{i}.bin", mime=mime)
        assert (body, ct) == jax_fasthttp.build_multipart(
            name, data, filename=f"n{i}.bin", mime=mime)
        got = fasthttp.parse_multipart(body, ct.encode())
        want = jax_fasthttp.parse_multipart(body, ct.encode())
        norm = lambda r: r and (bytes(r[0]), r[1], r[2])  # noqa: E731
        assert norm(got) == norm(want)
        for status in (200, 201, 404, 416, 501, 599):
            args = (status, data, b"text/plain", b"X-A: 1\r\n",
                    bool(i % 2), bool(i % 3 == 0))
            assert fasthttp.render_response(*args) == jax_fasthttp.render_response(*args)


def test_guard_and_jwt_equal_jax(monkeypatch):
    import time as _time

    monkeypatch.setattr(_time, "time", lambda: 1_700_000_000.0)
    tok = security.gen_jwt("k3y", 10, "3,01637037d6")
    assert tok == jax_security.gen_jwt("k3y", 10, "3,01637037d6")
    cases = [("Bearer " + tok, "3,01637037d6"), ("Bearer " + tok, "3,01637037d7"),
             ("Bearer " + tok, "3/01637037d6"), ("Bearer x.y.z", "3,01637037d6"),
             (tok, "3,01637037d6"), ("", "3,01637037d6"),
             ("Bearer " + tok, "3,01637037d6.jpg")]
    for wl in ((), ("10.0.0.1",), ("10.0.0.0/8", "127.0.0.1")):
        g = security.Guard(white_list=wl, signing_key="k3y")
        j = jax_security.Guard(white_list=wl, signing_key="k3y")
        for ip in ("127.0.0.1", "10.1.2.3", "192.168.0.1", "bad"):
            assert g.check_whitelist(ip) == j.check_whitelist(ip)
        for auth, fid in cases:
            assert g.check_jwt(auth, fid) == j.check_jwt(auth, fid), (auth, fid)


def test_rpc_port_convention_equals_jax():
    for addr in ("127.0.0.1:8080", "host:1", "[::1]:9333"):
        assert pb.grpc_address(addr) == jax_pb.grpc_address(addr)
        rpc = pb.grpc_address(addr)
        assert pb.http_address(rpc) == jax_pb.http_address(rpc) == addr
