"""The port's multi-process mesh: a two-process ``torch.distributed`` group
(gloo) on the CPU, the stand-in for several hosts, as
``tests/test_multihost.py`` runs the JAX package's.

Each process joins the group with ``initialize_distributed``, holds two
slots (``--device``, repeated), and builds the (dcn=2, batch=2) mesh with
``multihost_mesh``.  Every process runs the same global sweep over it:
``gain_spectrum`` at 13 points (not a multiple of 4) with rk4 and rk45,
solving its own slots' rows and getting the whole spectrum back through
``fetch_global``'s all-gather; each holds that to its own unsharded call at
rtol 1e-10 (``tests/multihost_worker.py``'s bar).  A timeout on every
process turns a hung rendezvous into a failure.

The worker is this file's ``__main__`` block, so the same processes run on
cards (``python tests/test_torch_multihost.py <rank> <n> <port> cuda:0``;
a device with ``{rank}`` in it names each process's own card, and a last
argument ``nccl`` picks that backend); it imports neither JAX nor the JAX
package.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_cluster(device: str = "cpu", nproc: int = 2, timeout: float = TIMEOUT_S,
                backend: str = "gloo"):
    """Start ``nproc`` workers on ``device`` over ``backend`` and wait for
    them: ``[(exit code, output)]`` by rank; the workers still running
    ``timeout`` seconds after the start are killed (code None)."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), str(rank),
                               str(nproc), str(port), device, backend],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=str(REPO))
             for rank in range(nproc)]
    deadline = time.monotonic() + timeout
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            results.append((p.returncode, out))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            results.append((None, out))
    return results


def test_two_process_cluster_sweep():
    results = run_cluster("cpu")
    for rank, (code, out) in enumerate(results):
        assert code == 0, f"worker {rank} failed (code {code}):\n{out[-4000:]}"
        assert f"MULTIHOST_OK p{rank}/2 mesh={{'dcn': 2, 'batch': 2}}" in out, out[-2000:]


def worker(rank: int, nproc: int, port: str, device: str, backend: str) -> None:
    import dataclasses
    import datetime

    import numpy as np
    import torch

    import psa_torch as T
    from psa_simulation_ode_rk_mvp_dispersion_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    device = device.format(rank=rank)
    ok = pm.initialize_distributed(coordinator_address=f"localhost:{port}",
                                   num_processes=nproc, process_id=rank, backend=backend,
                                   timeout=datetime.timedelta(seconds=TIMEOUT_S / 2))
    assert ok, "initialize_distributed returned False in a cluster run"
    assert torch.distributed.get_world_size() == nproc
    mesh = pm.multihost_mesh(device=[device] * 2)
    assert mesh is not None and mesh.spans_processes and "dcn" in mesh.axis_names, mesh
    assert [r for r in mesh.process_ids.ravel()] == [p for p in range(nproc) for _ in range(2)]

    # the global array comes back whole on every process
    x = np.arange(4 * nproc * 3, dtype=np.float64).reshape(-1, 3) * (1 + 1j)
    sharded = pm.put_global(x, pm.batch_sharding(mesh))
    assert len(sharded.shards) == 2 and sharded.shape == x.shape
    np.testing.assert_array_equal(pm.fetch_global(sharded), x)

    disp = T.dispersion_params_from_D_S(
        lambda_ref_m=1552e-9, D=0.1, S=0.02, dSdlmbd=0,
        D_units="ps/nm/km", S_units="ps/nm^2/km", dSdlmbd_units="ps/nm^3/km")
    cfg = T.custom_simulation_config(z_max=10.0, dz=0.2, save_every=5)
    kwargs = dict(cfg=cfg, lambda_p1_m=1550e-9, lambda_p2_m=1555e-9,
                  lambda_signal_m=np.linspace(1549e-9, 1561e-9, 13),   # deliberately not /4
                  gamma=0.0115, alpha=1.15e-4, p_in=[0.5, 0.5, 1e-7, 1e-7], dispersion=disp,
                  length_unit="m")
    for integrator in ("rk4", "rk45"):
        kw = dict(kwargs, cfg=dataclasses.replace(cfg, integrator=integrator))
        s = T.gain_spectrum(mesh=mesh, **kw)
        plain = T.gain_spectrum(device=device, **kw)
        assert np.all(s.ok) and np.array_equal(s.ok, plain.ok)
        np.testing.assert_allclose(s.gain, plain.gain, rtol=1e-10)
        print(f"{integrator}: bit for bit {np.array_equal(s.gain, plain.gain)}", flush=True)
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK p{rank}/{nproc} mesh={dict(mesh.shape)}", flush=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
           sys.argv[4] if len(sys.argv) > 4 else "cpu",
           sys.argv[5] if len(sys.argv) > 5 else "gloo")
