"""``pio train --mesh`` in a gang of processes on the CPU.

Two ``pio train --mesh data=4 --device cpu`` processes join one gloo gang
(``PIO_COORDINATOR_ADDRESS`` / ``PIO_NUM_PROCESSES`` /
``PIO_PROCESS_ID``, each with 2 CPU positions) over one sqlite store:
both print the ``Mesh:`` line of a 4-device mesh and the same engine
instance id, only process 0 writes, so the store holds one new engine
instance and it is COMPLETED, and its answers equal those of a
one-process ``--mesh data=4`` train on the same events within the
quickstart loop's tolerance (``tests/test_torch_cli.py``).  A gang that
fails or hangs fails the test within ``GANG_LIMIT_S``.
"""

import os
import re
import subprocess
import sys

import pytest

from tests.test_torch_cli import _agree, _variant
from tests.test_torch_gang_collectives import GANG_LIMIT_S, ROOT, _free_port
from tests.test_torch_mesh_cli import (  # noqa: F401
    USERS,
    _serve,
    _store,
    _train,
    clean_storage,
)


def _gang_train(ej) -> list:
    port = _free_port()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                       PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       PIO_NUM_PROCESSES="2", PIO_PROCESS_ID=str(rank),
                       XLA_FLAGS="--xla_force_host_platform_device_count=2")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch.cli", "train",
                 "--engine-json", str(ej), "--device", "cpu", "--mesh",
                 "data=4"], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = []
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=GANG_LIMIT_S)
            except subprocess.TimeoutExpired:
                pytest.fail(f"gang process {rank} did not finish in "
                            f"{GANG_LIMIT_S} s")
            assert p.returncode == 0, f"process {rank}:\n{err[-4000:]}"
            outs.append(out)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_pio_train_on_a_mesh_in_a_gang(clean_storage, capsys, tmp_path):
    from predictionio_tpu_torch.data.storage import get_storage

    _store(tmp_path, capsys)
    ej = _variant(tmp_path / "engine.json", app="meshapp", rank=8,
                  numIterations=4, seed=3)
    _, alone = _train(ej, capsys, "--mesh", "data=4")
    before = {i.id for i in get_storage().get_engine_instances().get_all()}
    outs = _gang_train(ej)
    ids = []
    for out in outs:
        assert "Mesh: {'data': 4} over 4 device(s)" in out
        assert "Training completed" in out
        ids.append(re.search(r"Engine instance ID: (\w+)", out).group(1))
    assert ids[0] == ids[1]
    instances = get_storage().get_engine_instances().get_all()
    new = [i for i in instances if i.id not in before]
    assert [i.id for i in new] == [ids[0]]
    assert new[0].status == "COMPLETED"
    got, _, _ = _serve(ej, ids[0])
    want, _, _ = _serve(ej, alone)
    assert len(got) == len(want) == len(USERS)
    for g, w in zip(got, want):
        _agree(g, w)
