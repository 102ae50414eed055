"""Two processes joined by ``torch.distributed`` along the mesh's dp axis:
the port of test_distributed.py.

Each process starts the group with ``parallel.mesh.init_distributed``
over gloo on a free loopback port, builds ``make_mesh(dp=2, sy=1, sx=2,
devices=[cpu, cpu])`` and owns one dp row of it.  ``sharded_statistics``,
``sharded_histogram``, a global sum and a gather of one global array are
reduced across the two processes, and both print the same totals, equal
to the single-process results.  A mesh made before the group is started
reduces within its process alone, and one made under the group raises
once the group is gone.
"""

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

coord, pid = sys.argv[1], int(sys.argv[2])
from imagemagick_tpu_torch.parallel import mesh as pm
from imagemagick_tpu_torch.parallel import spatial as sp

cpu = torch.device("cpu")
data = torch.arange(32 * 3, dtype=torch.float32).reshape(2, 4, 4, 3) / 95.0
# a mesh made before the group holds every dp row: its reductions are
# whole in each process and never all-reduced
early = pm.make_mesh(dp=2, sy=1, sx=2, devices=[cpu] * 4)
n = pm.init_distributed(coord, num_processes=2, process_id=pid,
                        device="cpu")
assert n == 2, f"expected 2 global devices, saw {n}"
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
assert not early.grouped and int(sp.sharded_histogram(early)(data).sum()) \
    == 96 and float(sp.sharded_statistics(early)(data)[3][2]) == 1.0
mesh = pm.make_mesh(dp=2, sy=1, sx=2, devices=[cpu, cpu])
assert mesh.grouped and mesh.devices.shape == (1, 1, 2) and \
    mesh.dp_offset == pid
xs = pm.device_put(data, pm.batch_sharding(mesh))
assert torch.equal(xs.blocks[0, 0, 1], data[pid:pid + 1, :, 2:])
mean, std, mn, mx = sp.sharded_statistics(mesh)(xs)
hist = sp.sharded_histogram(mesh, bins=256)(xs)
hist64 = sp.sharded_histogram(mesh, bins=64)(xs)
total = pm.device_put(torch.arange(32, dtype=torch.float32).reshape(4, 8),
                      pm.NamedSharding(mesh, pm.P("dp", "sx"))).sum()
assert torch.equal(xs.gather(), data)
print("TOTAL", f"{float(total):.1f}", "COUNT", int(hist.sum()),
      int(hist64.sum()), "MEAN", mean.tolist(), "STD", std.tolist(),
      "MIN", mn.tolist(), "MAX", mx.tolist(), "HIST", hist.tolist(),
      flush=True)
dist.destroy_process_group()
# a mesh made under the group does not reduce once it is gone
try:
    sp.sharded_histogram(mesh)(xs)
except ValueError as e:
    assert "no group is started now" in str(e), e
else:
    raise AssertionError("a grouped mesh reduced without its group")
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh(tmp_path):
    import torch

    from imagemagick_tpu_torch.parallel import mesh as pm
    from imagemagick_tpu_torch.parallel import spatial as sp

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, str(worker), coord, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(out.strip().splitlines()[-1])
    # both processes reduced the same global arrays: sum(0..31) = 496
    assert outs[0] == outs[1]
    assert outs[0].startswith("TOTAL 496.0 COUNT 96 96 ")
    # and agree with one process holding the whole mesh
    data = torch.arange(32 * 3, dtype=torch.float32).reshape(2, 4, 4, 3) \
        / 95.0
    mesh = pm.make_mesh(2, 1, 2, devices=[torch.device("cpu")] * 4)
    mean, std, mn, mx = sp.sharded_statistics(mesh)(data)
    hist = sp.sharded_histogram(mesh, bins=256)(data)
    assert outs[0].endswith(
        f"MEAN {mean.tolist()} STD {std.tolist()} MIN {mn.tolist()} "
        f"MAX {mx.tolist()} HIST {hist.tolist()}")
