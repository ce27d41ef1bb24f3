"""The port's collectives across a gang of processes, and the gang
harness the other ``tests/test_torch_gang_*.py`` files share.

A gang here is two gloo processes on the CPU, each driving 2 of a
4-position mesh (``PIO_COORDINATOR_ADDRESS`` / ``PIO_NUM_PROCESSES`` /
``PIO_PROCESS_ID``, ``XLA_FLAGS`` giving each 2 CPU positions), beside
one process driving all 4: the same cases run in both, and the
gang's results must be ``torch.equal`` to the one process's.  Every
process pins ``OMP_NUM_THREADS=1``, so the CPU's reductions split the
same way in all three.  A gang that fails or hangs fails its test within
``GANG_LIMIT_S``; every process is killed on the way out.

Here each collective with gradients (``psum`` and ``all_gather`` to
every position, ``replicate``, ``psum_scatter``, ``all_to_all``,
``ppermute``) runs forward and backward on seeded parts: the outputs
and the gradients of the gang equal the one process's bit for bit, the
sums are within 1e-6 of JAX's inside the reference's ``shard_map``, and
the gradients within 1e-6 of ``jax.grad``'s.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
GANG_LIMIT_S = 240
SUM_ATOL = 1e-6
N = 4


# -- the harness --------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_gang(cases: str, out_dir: Path, *, limit_s: float = GANG_LIMIT_S,
             env: dict = None) -> dict:
    """Run ``cases`` (``"module:case_a,case_b"``, functions of a test
    module returning a dict of tensors/arrays) in a gang of two
    processes with 2 positions each and in one process with 4, all at
    once.  Returns ``{"gang": [rank 0's, rank 1's], "one": ...}``."""
    port = _free_port()
    out_dir.mkdir(parents=True, exist_ok=True)
    base = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                PIO_GANG_CASES=cases, PIO_GANG_OUT=str(out_dir),
                **(env or {}))
    for k in ("PIO_COORDINATOR_ADDRESS", "PIO_NUM_PROCESSES",
              "PIO_PROCESS_ID"):
        base.pop(k, None)
    def positions(n: int) -> str:
        return f"--xla_force_host_platform_device_count={n}"

    runs = {f"gang-{r}": dict(base, XLA_FLAGS=positions(2),
                              PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                              PIO_NUM_PROCESSES="2", PIO_PROCESS_ID=str(r))
            for r in (0, 1)}
    runs["one-0"] = dict(base, XLA_FLAGS=positions(4))
    procs = {}
    try:
        for name, e in runs.items():
            e["PIO_GANG_NAME"] = name
            procs[name] = subprocess.Popen(
                [sys.executable, "-c",
                 "from tests.test_torch_gang_collectives import gang_main; "
                 "gang_main()"],
                env=e, cwd=str(ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for name, p in procs.items():
            try:
                _, err = p.communicate(timeout=limit_s)
            except subprocess.TimeoutExpired:
                pytest.fail(f"{name} of the gang did not finish in "
                            f"{limit_s} s")
            assert p.returncode == 0, f"{name}:\n{err[-4000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    got = {n: torch.load(out_dir / f"{n}.pt", weights_only=False)
           for n in runs}
    return {"gang": [got["gang-0"], got["gang-1"]], "one": got["one-0"]}


def gang_main() -> None:
    """A gang process's body: join the gang (gloo) when the environment
    names one, run the cases, save their results."""
    import importlib

    from predictionio_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )

    torch.set_num_threads(1)
    joined = initialize_distributed(backend="gloo")
    module, names = os.environ["PIO_GANG_CASES"].split(":")
    mod = importlib.import_module(module)
    out = {name: getattr(mod, name)() for name in names.split(",")}
    torch.save(out, Path(os.environ["PIO_GANG_OUT"])
               / f"{os.environ['PIO_GANG_NAME']}.pt")
    if joined:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


def assert_equal_trees(got, want, where: str = "") -> None:
    """``torch.equal`` leaf by leaf (numpy arrays compared as tensors)."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_equal_trees(got[k], want[k], f"{where}/{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_trees(g, w, f"{where}[{i}]")
        return
    if isinstance(want, (torch.Tensor, np.ndarray)):
        g, w = torch.as_tensor(got), torch.as_tensor(want)
        assert g.shape == w.shape and torch.equal(g, w), \
            f"{where}: max |diff| " \
            f"{(g.double() - w.double()).abs().max().item()}"
        return
    assert got == want, where


def merged(gang: list, *keys) -> dict:
    """One result's per-position dicts of both gang processes (at
    ``r[keys[0]][keys[1]]...``), merged: each process reports the
    positions it drives."""
    out = {}
    for r in gang:
        for k in keys:
            r = r[k]
        out.update(r)
    return out


# -- the collectives' cases (run in every process) ----------------------------


def _data():
    rng = np.random.default_rng(11)
    return {
        "blocks": rng.standard_normal((N, N * 2, N, 3)).astype(np.float32),
        "w": rng.standard_normal((N, N * 2 * N, N, 3)).astype(np.float32),
        "rep": rng.standard_normal((5, N, 3)).astype(np.float32),
    }


def _ops():
    from predictionio_tpu_torch.parallel.compat import (
        all_gather,
        all_to_all,
        ppermute,
        psum,
        psum_scatter,
    )

    perm = [(i, (i + 1) % N) for i in range(N)]
    return {
        "psum": lambda parts, mesh: psum(parts, mesh, each=True),
        "all_gather": lambda parts, mesh: all_gather(parts, mesh,
                                                     each=True),
        "psum_scatter": lambda parts, mesh: psum_scatter(parts, mesh,
                                                         dim=1),
        "all_to_all": lambda parts, mesh: all_to_all(
            parts, mesh, split_dim=1, concat_dim=0),
        "ppermute": lambda parts, mesh: ppermute(parts, mesh, perm=perm),
    }


def _weight(w: np.ndarray, shape) -> torch.Tensor:
    """The cotangent weights of an output of ``shape``, cut from ``w``."""
    return torch.from_numpy(np.ascontiguousarray(
        w[tuple(slice(0, s) for s in shape)]))


def case_collectives() -> dict:
    """Each collective's outputs and the gradients of
    ``Σ_c <w_c, out_c>`` on this process's positions."""
    from predictionio_tpu_torch.parallel.compat import replicate
    from predictionio_tpu_torch.parallel.mesh import make_mesh

    data = _data()
    mesh = make_mesh({"data": N}, device="cpu")
    local = mesh.local_positions()
    out = {}
    for name, fn in _ops().items():
        parts = [torch.from_numpy(data["blocks"][p].copy())
                 .requires_grad_(True) for p in local]
        outs = fn(parts, mesh)
        total = sum((o * _weight(data["w"][p], o.shape)).sum()
                    for p, o in zip(local, outs))
        total.backward()
        out[name] = {p: (o.detach(), x.grad)
                     for p, o, x in zip(local, outs, parts)}
    rep = torch.from_numpy(data["rep"].copy()).requires_grad_(True)
    copies = replicate([rep], [torch.device("cpu")] * len(local), mesh)
    total = sum((c[0] * _weight(data["w"][p], c[0].shape)).sum()
                for p, c in zip(local, copies))
    total.backward()
    out["replicate"] = {"first": None if rep.grad is None else rep.grad,
                        "rank0": local[0] == 0}
    return out


def case_env_mesh() -> dict:
    """The mesh ``pio train --mesh data=4`` builds from
    ``PIO_MESH_DEVICES`` naming the gang's 4 positions."""
    import tempfile

    from predictionio_tpu_torch.config import memory_config
    from predictionio_tpu_torch.controller import RuntimeContext
    from predictionio_tpu_torch.data.storage import Storage

    os.environ["PIO_MESH_DEVICES"] = ",".join(["cpu"] * N)
    try:
        mesh = RuntimeContext.create(
            storage=Storage(memory_config(tempfile.mkdtemp())),
            device="cpu", mesh_spec=f"data={N}").mesh
    finally:
        del os.environ["PIO_MESH_DEVICES"]
    return {"procs": mesh.process_ids.tolist(),
            "local": mesh.local_positions()}


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return run_gang("tests.test_torch_gang_collectives:case_collectives,"
                    "case_env_mesh",
                    tmp_path_factory.mktemp("gang_collectives"))


def test_pio_mesh_devices_names_the_gangs_positions(collectives):
    """``PIO_MESH_DEVICES`` in a gang lists the whole gang's devices:
    each process drives its equal run of them, in rank order."""
    assert collectives["one"]["case_env_mesh"] == {
        "procs": [0] * N, "local": list(range(N))}
    for rank, r in enumerate(collectives["gang"]):
        assert r["case_env_mesh"] == {"procs": [0, 0, 1, 1],
                                      "local": [2 * rank, 2 * rank + 1]}


@pytest.mark.parametrize("name", list(_ops()) + ["replicate"])
def test_gang_collective_equals_one_process(collectives, name):
    gang, one = collectives["gang"], collectives["one"]
    if name == "replicate":
        # the value's gradient lands on the first process's copy only
        first = [g["case_collectives"]["replicate"] for g in gang]
        assert first[0]["rank0"] and not first[1]["rank0"]
        assert first[1]["first"] is None
        assert_equal_trees(first[0]["first"],
                           one["case_collectives"]["replicate"]["first"])
        return
    got = merged(gang, "case_collectives", name)
    want = one["case_collectives"][name]
    assert sorted(got) == sorted(want) == list(range(N))
    assert_equal_trees(got, want, name)


def _jax_reference(name, data):
    """JAX's outputs and ``jax.grad`` of the same weighted sum, inside
    the reference's ``shard_map`` over 4 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from predictionio_tpu.parallel.compat import shard_map as jax_shard_map
    from predictionio_tpu.parallel.mesh import make_mesh as jax_make_mesh

    perm = [(i, (i + 1) % N) for i in range(N)]
    bodies = {
        "psum": lambda x: jax.lax.psum(x, "data"),
        "all_gather": lambda x: jax.lax.all_gather(x[0], "data",
                                                   tiled=True)[None],
        "psum_scatter": lambda x: jax.lax.psum_scatter(
            x, "data", scatter_dimension=2, tiled=True),
        "all_to_all": lambda x: jax.lax.all_to_all(
            x, "data", split_axis=2, concat_axis=1, tiled=True),
        "ppermute": lambda x: jax.lax.ppermute(x, "data", perm),
    }
    mesh = jax_make_mesh({"data": N})
    fn = jax_shard_map(bodies[name], mesh=mesh, in_specs=JP("data"),
                       out_specs=JP("data"))
    whole = jnp.asarray(data["blocks"])
    outs = np.asarray(fn(whole))
    w = jnp.asarray(np.stack([np.asarray(_weight(data["w"][p],
                                                 outs.shape[1:]))
                              for p in range(N)]))
    grads = jax.grad(lambda x: (fn(x) * w).sum())(whole)
    return outs, np.asarray(grads)


@pytest.mark.parametrize("name", list(_ops()))
def test_gang_collective_against_jax(collectives, name):
    got = merged(collectives["gang"], "case_collectives", name)
    outs, grads = _jax_reference(name, _data())
    for p in range(N):
        o, g = got[p]
        np.testing.assert_allclose(o.numpy(), outs[p], rtol=0,
                                   atol=SUM_ATOL)
        np.testing.assert_allclose(g.numpy(), grads[p], rtol=0,
                                   atol=SUM_ATOL)
