"""The port's ``parallel/`` against the reference's: mesh shapes, the
wildcard, the errors with the reference's messages, ``put_sharded``,
``shard_map`` with the psum and all_gather collectives, the collective
micro-benchmark, ``parse_mesh_spec``, and a gang of two gloo processes.

The reference's mesh is its 8 virtual CPU devices (``tests/conftest.py``
sets ``XLA_FLAGS``); the port's CPU mesh reads the same setting, so both
default to 8 shards.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.parallel import (
    AXIS_DATA,
    AXIS_MODEL,
    batch_sharding,
    cpu_devices_requested,
    make_mesh,
    replicated,
    sharding,
)
from predictionio_tpu_torch.parallel.collectives import collective_microbench
from predictionio_tpu_torch.parallel.compat import all_gather, psum, shard_map
from predictionio_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_multi_host,
    process_count,
    process_index,
)
from predictionio_tpu_torch.parallel.mesh import (
    PartitionSpec,
    mesh_from_spec,
    parse_mesh_spec,
    put_sharded,
)

ROOT = Path(__file__).resolve().parents[1]
GANG_LIMIT_S = 60


def _cpu_mesh(sizes=None):
    return make_mesh(sizes, device="cpu")


def test_both_packages_see_eight_cpu_devices():
    import jax

    from predictionio_tpu.parallel.mesh import cpu_devices_requested as ref

    assert cpu_devices_requested() == ref() == len(jax.devices()) == 8


def test_make_mesh_default():
    m = _cpu_mesh()
    assert m.axis_names == (AXIS_DATA,)
    assert m.shape[AXIS_DATA] == 8 and m.devices.size == 8
    assert all(d == torch.device("cpu") for d in m.devices.flat)


def test_make_mesh_2d_and_wildcard():
    from predictionio_tpu.parallel.mesh import make_mesh as ref

    for sizes in ({AXIS_DATA: 4, AXIS_MODEL: 2}, {AXIS_DATA: -1, AXIS_MODEL: 2},
                  {AXIS_DATA: 3}, {AXIS_MODEL: -1}):
        assert dict(_cpu_mesh(sizes).shape) == dict(ref(sizes).shape)


@pytest.mark.parametrize("sizes", [{AXIS_DATA: 16},
                                   {AXIS_DATA: -1, AXIS_MODEL: 3},
                                   {AXIS_DATA: -1, AXIS_MODEL: -1}])
def test_make_mesh_errors_carry_the_reference_messages(sizes):
    from predictionio_tpu.parallel.mesh import make_mesh as ref

    with pytest.raises(ValueError) as want:
        ref(sizes)
    with pytest.raises(ValueError) as got:
        _cpu_mesh(sizes)
    assert str(got.value) == str(want.value)


def test_an_explicit_device_list_may_repeat_a_device():
    m = make_mesh({AXIS_DATA: 4}, devices=["cpu"] * 4)
    assert m.shape == {AXIS_DATA: 4} and not m.multi_process
    with pytest.raises(ValueError, match="need 8 devices"):
        make_mesh({AXIS_DATA: 8}, devices=["cpu"] * 4)


def test_parse_mesh_spec_as_the_reference():
    from predictionio_tpu.parallel.mesh import parse_mesh_spec as ref

    for spec in ("data=8", "data=4,model=2", "auto", "AUTO", "8", "",
                 " data=-1 , model=2 ", "data=2,,model=4"):
        assert parse_mesh_spec(spec) == ref(spec), spec
    for bad in ("bogus", "data=0,model=-1", "data=8,x", "model=-2"):
        with pytest.raises(ValueError) as want:
            ref(bad)
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(bad)
        assert str(got.value) == str(want.value), bad


def test_mesh_from_spec():
    assert mesh_from_spec("", device="cpu") is None
    assert mesh_from_spec("none", device="cpu") is None
    assert mesh_from_spec("off", device="cpu") is None
    assert dict(mesh_from_spec("1", device="cpu").shape) == {"data": 1}
    assert dict(mesh_from_spec("data=4,model=2", device="cpu").shape) \
        == {"data": 4, "model": 2}


def test_put_sharded_blocks_and_specs():
    m = _cpu_mesh({AXIS_DATA: 4, AXIS_MODEL: 2})
    a = np.arange(32, dtype=np.float32).reshape(8, 4)
    x = put_sharded(a, m, sharding(m, AXIS_DATA, AXIS_MODEL))
    assert x.shape == (8, 4) and x.spec == PartitionSpec("data", "model")
    # position (data=1, model=1) holds rows 2:4, columns 2:4
    np.testing.assert_array_equal(x.block(3).numpy(), a[2:4, 2:4])
    np.testing.assert_array_equal(x.to_host(), a)
    b = put_sharded(a, m, batch_sharding(m))
    assert b.spec == PartitionSpec(AXIS_DATA)
    np.testing.assert_array_equal(b.block(2).numpy(), a[2:4])
    r = put_sharded(a, m, replicated(m))
    assert r.sharding.is_fully_replicated
    # one device: every position shares the one replica
    assert len({id(t) for t in r.shards}) == 1
    np.testing.assert_array_equal(r.to_host(), a)
    with pytest.raises(ValueError, match="does not divide"):
        put_sharded(np.zeros((6, 2)), m, batch_sharding(m))


def test_psum_semantics_on_mesh():
    """shard_map + psum over the data axis == the global sum (the
    reference's treeAggregate analogue)."""
    m = _cpu_mesh()
    xs = put_sharded(torch.ones(8, 4), m, batch_sharding(m))
    parts = shard_map(lambda axis_index, v: v.sum().reshape(1, 1), mesh=m,
                      in_specs=PartitionSpec(AXIS_DATA), out_specs=None)(xs)
    assert float(psum(parts, m)) == 32.0


def test_psum_adds_in_shard_order():
    """A fixed order: the same bits on every run, and the left fold's."""
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.normal(size=5).astype(np.float32) * 10 ** e)
             for e in range(-4, 4)]
    want = parts[0].clone()
    for p in parts[1:]:
        want = want + p
    assert torch.equal(psum(parts), want)
    assert torch.equal(psum(parts), psum(list(parts)))


def test_all_gather_and_axis_index():
    m = _cpu_mesh()
    xs = put_sharded(torch.arange(16.0).reshape(16, 1), m, batch_sharding(m))

    def local(axis_index, v):
        return v + 100 * axis_index(AXIS_DATA)

    parts = shard_map(local, mesh=m, in_specs=(PartitionSpec(AXIS_DATA),),
                      out_specs=None)(xs)
    got = all_gather(parts, m).ravel()
    want = torch.arange(16.0) + 100 * (torch.arange(16) // 2)
    assert torch.equal(got, want)
    sharded = shard_map(local, mesh=m, in_specs=(PartitionSpec(AXIS_DATA),),
                        out_specs=PartitionSpec(AXIS_DATA))(xs)
    np.testing.assert_array_equal(sharded.to_host().ravel(), want.numpy())
    first = shard_map(lambda axis_index, v: v.sum(), mesh=m,
                      in_specs=(PartitionSpec(),),
                      out_specs=PartitionSpec())(torch.ones(3))
    assert float(first) == 3.0


def test_collective_microbench_runs():
    res = collective_microbench(_cpu_mesh(), size_mb=0.25, iters=2)
    assert set(res) == {"all_reduce", "all_gather", "all_to_all"}
    for v in res.values():
        assert v["seconds"] > 0 and v["algo_bw_gbps"] > 0
        assert v["axis_size"] == 8.0


def test_distributed_is_a_noop_without_the_env(monkeypatch):
    monkeypatch.delenv("PIO_COORDINATOR_ADDRESS", raising=False)
    assert initialize_distributed() is False
    assert (process_index(), process_count(), is_multi_host()) == (0, 1,
                                                                   False)


# -- a gang of two gloo processes --------------------------------------------

_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch
    from predictionio_tpu_torch.models.als import _window_gather
    from predictionio_tpu_torch.ops.topk import sharded_top_k
    from predictionio_tpu_torch.parallel.distributed import (
        initialize_distributed, process_count, process_index)
    from predictionio_tpu_torch.parallel.mesh import (
        PartitionSpec, make_mesh, put_sharded)

    assert initialize_distributed(backend="gloo")
    mesh = make_mesh(device="cpu")
    rng = np.random.default_rng(7)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    items = rng.normal(size=(40, 8)).astype(np.float32)
    win = np.sort(rng.choice(40, 11, replace=False)).astype(np.int64)
    it = put_sharded(items, mesh, PartitionSpec("data"))
    s, i = sharded_top_k(mesh, "data", torch.from_numpy(q), it, 6,
                         n_valid=37)
    rows = _window_gather(put_sharded(items, mesh,
                                      PartitionSpec("data", None)),
                          torch.from_numpy(win))
    print(json.dumps({"rank": process_index(), "world": process_count(),
                      "shards": mesh.shape["data"],
                      "local": len(mesh.local_positions()),
                      "s": s.tolist(), "i": i.tolist(),
                      "rows": rows.tolist(),
                      "host": it.to_host().tolist()}))
    torch.distributed.destroy_process_group()
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_equal_one_process():
    """``sharded_top_k`` and ``_window_gather`` over a mesh of 4 shards,
    2 in each of two processes, equal the answer of one process with all
    4; the gang joins under a limit of its own and fails, not hangs."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   PIO_NUM_PROCESSES="2", PIO_PROCESS_ID=str(rank),
                   XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=GANG_LIMIT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo gang did not finish in {GANG_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    from predictionio_tpu_torch.models.als import _window_gather

    rng = np.random.default_rng(7)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    items = rng.normal(size=(40, 8)).astype(np.float32)
    win = np.sort(rng.choice(40, 11, replace=False)).astype(np.int64)
    mesh = make_mesh({"data": 4}, device="cpu")
    from predictionio_tpu_torch.ops.topk import sharded_top_k

    s, i = sharded_top_k(mesh, "data", torch.from_numpy(q),
                         put_sharded(items, mesh, PartitionSpec("data")), 6,
                         n_valid=37)
    rows = _window_gather(put_sharded(items, mesh,
                                      PartitionSpec("data", None)),
                          torch.from_numpy(win))
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert (o["world"], o["shards"], o["local"]) == (2, 4, 2)
        np.testing.assert_array_equal(np.asarray(o["s"], np.float32),
                                      s.numpy())
        np.testing.assert_array_equal(o["i"], i.numpy())
        np.testing.assert_array_equal(np.asarray(o["rows"], np.float32),
                                      rows.numpy())
        np.testing.assert_array_equal(np.asarray(o["host"], np.float32),
                                      items)
