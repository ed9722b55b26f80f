"""The port's distributed layer across two real processes (the twin of
tests/test_distributed.py).

Two spawned processes join a gloo group on the CPU through
``parallel.init_distributed`` (a second call is the no-op, a call with
another world size raises) and run:

* ``render_image_sharded`` on the 1 x 2 ray mesh (the slots gathered with
  ``all_gather``) against the one-process render, and at four samples on
  a 2 x 1 sample mesh (the means averaged with ``all_reduce``) against
  ``render_image`` on the same draws; ``render_stokes_sharded`` likewise;
* the multi-process branch of ``gather_image``;
* two ``Trainer`` steps, the gradient average crossing the processes: the
  loss and the mass the same bits on both ranks.

The workers import torch and the port only.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)

port, pid = sys.argv[1], int(sys.argv[2])
from blackhole_geodesic_calculator_tpu_torch.parallel import (
    Trainer, gather_image, global_mesh, init_distributed, make_mesh,
    render_image_sharded, render_stokes_sharded)
import blackhole_geodesic_calculator_tpu_torch as P

addr = f"127.0.0.1:{port}"
assert init_distributed(addr, num_processes=2, process_id=pid) is True
assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
# a second call is the documented no-op; another world size is refused
assert init_distributed(addr, num_processes=2, process_id=pid) is True
try:
    init_distributed(addr, num_processes=3, process_id=pid)
    raise SystemExit("a conflicting world size was accepted")
except RuntimeError:
    pass

v, u = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
sky = torch.as_tensor(np.stack([u / 16.0, v / 8.0, np.ones_like(u, float)],
                               -1), dtype=torch.float32)
scene = P.Scene(bh=P.BlackHole.make(mass=0.5, device="cpu"), background=sky)
cam = P.Camera.make(position=(0.0, 0.0, 15.0), fov=(0.7, 0.7), device="cpu")
cfg = P.RenderConfig(width=16, height=16, lam_max=60.0,
                     integrator=P.IntegratorConfig(n_steps=32, dt=0.2))

mesh = global_mesh()
assert mesh.shape == {"samples": 1, "rays": 2} and mesh.coords() == (0, pid)

# --- sharded render across both processes vs the one-process render ----
img = render_image_sharded(scene, cam, cfg, mesh=mesh)
ref = P.render_image(scene, cam, cfg)
err = float((img - ref).abs().max())
assert err < 2e-5, f"sharded-vs-single mismatch {err}"

# --- samples split over the processes: the means all_reduced -----------
cfg4 = dataclasses.replace(cfg, samples=4)
smesh = make_mesh(sample_parallel=2)
assert smesh.shape == {"samples": 2, "rays": 1}
draws = P.render.sample_draws(cfg4, "cpu")
err4 = float((render_image_sharded(scene, cam, cfg4, smesh, draws)
              - P.render_image(scene, cam, cfg4, draws)).abs().max())
assert err4 < 1e-6, f"sample-sharded mismatch {err4}"

# --- the Stokes frame of a polarized disk -------------------------------
tex = torch.tensor([1.0, 0.6, 0.2]).expand(8, 32, 3).contiguous()
dscene = dataclasses.replace(scene, disk=P.Disk.make(
    r_in=2.0, r_out=6.0, texture=tex, pol_frac=0.5, device="cpu"))
dcam = P.Camera.make(position=(0.0, 6.0, 14.0), euler=(-0.4, 0.0, 0.0),
                     fov=(0.8, 0.8), device="cpu")
for a, b in zip(render_stokes_sharded(dscene, dcam, cfg, mesh),
                P.render_stokes(dscene, dcam, cfg)):
    assert float((a - b).abs().max()) < 2e-5

# --- multi-process gather_image branch ----------------------------------
g = gather_image(np.full((2, 4, 3), pid, np.float32), axis=0)
assert g.shape == (4, 4, 3), g.shape
assert (g[:2] == 0.0).all() and (g[2:] == 1.0).all()

# --- two Trainer steps: the gradient average crosses the processes ------
def param_fn(p):
    return (dataclasses.replace(scene, bh=dataclasses.replace(
        scene.bh, mass=p["mass"])), cam)

tr = Trainer(cfg=cfg, param_fn=param_fn,
             optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-2), mesh=mesh)
p2, losses = tr.fit({"mass": 0.45}, ref, n_steps=2)
mass2 = float(p2["mass"])
assert np.isfinite(losses).all() and mass2 != 0.45
dist.destroy_process_group()
print(f"RESULT pid={pid} err={err:.3e} loss0={losses[0].hex()} "
      f"loss1={losses[1].hex()} mass={mass2.hex()}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_render_and_train(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(port), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"

    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT")]
        assert len(lines) == 1, out
        results.append(dict(kv.split("=") for kv in lines[0].split()[1:]))
    r0, r1 = results
    assert {r0["pid"], r1["pid"]} == {"0", "1"}
    for k in ("loss0", "loss1", "mass"):
        assert r0[k] == r1[k], k
