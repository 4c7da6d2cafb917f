"""Run the experiment scripts' `_torch` twins on the CPU with one Python start.

Each twin is a bash script that starts a Python process per CLI call, and each
such process spends seconds importing torch, scipy.stats and the port before
it does a smoke-scale second of work. `TwinRunner` starts one server process
that imports them once; a `python` on the twin's PATH hands its argv, working
directory, environment and standard streams to the server, which forks a
child that runs the module (``python -m``) or script as ``__main__``, as a new
interpreter would, and returns its exit code. The bash scripts run as they
are; only the interpreter's start is shared. Any other form of ``python``
call goes to the real interpreter.

The child runs with one torch thread: the tier runs six test workers at once,
and tiny U-Nets on all cores ran many times slower. Two stand-ins a twin's
environment may ask for: ``TWIN_RUNNER_LOWRANK_SQRTM`` gives the child an
exact scipy ``sqrtm`` for low-rank products (an FID of a few samples), which
takes milliseconds where scipy's takes 20 s at 2048-d; and
``TWIN_RUNNER_FEATURE_WIDTH=<n>`` replaces TRAK's ``make_grad_feature_fn``
by a seeded projection of the pixels to n columns, for a script whose fixed
flags (4096 columns of a 1M-parameter U-Net's gradients) cost minutes here.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

_SERVER = r'''
import atexit, json, os, runpy, socket, sys, traceback
os.environ.setdefault("OMP_NUM_THREADS", "1")
import numpy, scipy.linalg, scipy.stats, torch  # noqa: E401,F401
torch.set_num_threads(1)
import group_attribution_for_diffusion_models_tpu_torch.attributions  # noqa: F401
import group_attribution_for_diffusion_models_tpu_torch.cli.common  # noqa: F401
import group_attribution_for_diffusion_models_tpu_torch.parallel  # noqa: F401
import group_attribution_for_diffusion_models_tpu_torch.pruning  # noqa: F401


def lowrank_sqrtm(a, *args, **kwargs):
    """The principal square root of a = q b (q orthonormal, rank r): with
    b q = w diag(l) w^-1, sqrtm(a) = q w diag(l)^-1/2 w^-1 b, exactly, in
    O(n^2 r) where scipy's Schur route takes O(n^3)."""
    import numpy as np
    u, s, _ = np.linalg.svd(a @ np.random.default_rng(0).standard_normal((a.shape[0], 64)),
                            full_matrices=False)
    q = u[:, s > s[0] * 1e-10]
    b = q.T @ a
    if not np.allclose(q @ b, a, atol=1e-9 * max(1.0, np.abs(a).max())):
        return scipy_sqrtm(a, *args, **kwargs)
    lam, w = np.linalg.eig(b @ q)
    return (q @ w) @ np.diag(lam.astype(complex) ** -0.5) @ np.linalg.solve(w, b)


def stand_in_feature_fn(model, *args, proj_seed=0, **kwargs):
    """A make_grad_feature_fn stand-in: one fixed seeded projection of the
    pixels to TWIN_RUNNER_FEATURE_WIDTH columns, for every variant."""
    width = int(os.environ["TWIN_RUNNER_FEATURE_WIDTH"])

    def features(batch, generator=None):
        g = torch.Generator().manual_seed(proj_seed)
        proj = torch.randn(batch[0].numel(), width, generator=g)
        return batch.flatten(1).float().cpu() @ proj
    return features


scipy_sqrtm = scipy.linalg.sqrtm
srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
srv.bind("\0" + sys.argv[1])  # an abstract name: no file, no path-length limit
srv.listen(4)
print("ready", flush=True)
while True:
    conn, _ = srv.accept()
    msg, fds, _, _ = socket.recv_fds(conn, 1 << 22, 3)
    req = json.loads(msg)
    pid = os.fork()
    if pid:
        for fd in fds:
            os.close(fd)
        conn.close()
        os.waitpid(pid, 0)
        continue
    srv.close()
    for target, fd in enumerate(fds):
        os.dup2(fd, target)
        os.close(fd)
    os.chdir(req["cwd"])
    os.environ.clear()
    os.environ.update(req["env"])
    if req["env"].get("TWIN_RUNNER_LOWRANK_SQRTM"):
        scipy.linalg.sqrtm = lowrank_sqrtm
    if req["env"].get("TWIN_RUNNER_FEATURE_WIDTH"):
        from group_attribution_for_diffusion_models_tpu_torch.attributions.methods import trak
        trak.make_grad_feature_fn = stand_in_feature_fn
    code = 0
    try:
        if req["module"]:
            sys.argv = [req["module"], *req["argv"]]
            sys.path[0] = req["cwd"]
            sys.modules.pop(req["module"], None)
            runpy.run_module(req["module"], run_name="__main__", alter_sys=True)
        else:
            sys.argv = list(req["argv"])
            sys.path[0] = os.path.dirname(os.path.abspath(sys.argv[0]))
            runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        if isinstance(e.code, int) or e.code is None:
            code = e.code or 0
        else:
            print(e.code, file=sys.stderr)
            code = 1
    except BaseException:
        traceback.print_exc()
        code = 1
    atexit._run_exitfuncs()
    sys.stdout.flush()
    sys.stderr.flush()
    conn.sendall(str(code).encode())
    os._exit(code)
'''

# The `python` on a twin's PATH: started with -S (no site packages, no
# startup imports), it forwards `python -m mod ...` and `python script ...`
# to the server and execs the real interpreter for anything else.
_CLIENT = r'''#!/usr/bin/env bash
exec "{python}" -S -c '
import json, os, socket, sys
real, argv = sys.argv[1], sys.argv[2:]
module = argv[1] if argv[:1] == ["-m"] and len(argv) > 1 else None
if module is None and (not argv or argv[0].startswith("-")):
    os.execv(real, [real] + argv)
req = {{"module": module, "argv": argv[2:] if module else argv,
       "cwd": os.getcwd(), "env": dict(os.environ)}}
s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
s.connect("\0" + os.environ["TWIN_RUNNER_SOCKET"])
socket.send_fds(s, [json.dumps(req).encode()], [0, 1, 2])
code = s.recv(16)
sys.exit(int(code) if code else 1)
' "{python}" "$@"
'''


class TwinRunner:
    """A server that imports the port once, and a PATH on which `python`
    reaches it. `run(script, env, args)` runs a twin (bash for a ``.sh``,
    that `python` for a ``.py``) from the repo root with `env` over this
    process's environment and returns its CompletedProcess, with `seconds`;
    `close()` stops the server."""

    def __init__(self, repo: str):
        self.repo = repo
        self.dir = tempfile.mkdtemp(prefix="twin_runner_")
        self.socket = f"gadm_twin_runner_{os.getpid()}_{os.urandom(6).hex()}"
        with open(os.path.join(self.dir, "python"), "w") as f:
            f.write(_CLIENT.format(python=sys.executable))
        os.chmod(os.path.join(self.dir, "python"), 0o755)
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        self.server = subprocess.Popen(
            [sys.executable, "-c", _SERVER, self.socket], cwd=repo, env=env,
            stdout=subprocess.PIPE, text=True)
        if self.server.stdout.readline().strip() != "ready":
            self.close()
            raise RuntimeError("the twin runner's server did not start")

    def run(self, script: str, env: dict, args=(), timeout: float = 600):
        full = dict(os.environ)
        full.pop("PYTHONPATH", None)
        full.update(env, PATH=f"{self.dir}:{os.environ['PATH']}",
                    TWIN_RUNNER_SOCKET=self.socket)
        cmd = ["bash" if script.endswith(".sh") else os.path.join(self.dir, "python"), script,
               *args]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=self.repo, env=full, capture_output=True,
                              text=True, timeout=timeout)
        proc.seconds = time.perf_counter() - t0
        return proc

    def close(self):
        self.server.kill()
        self.server.wait(timeout=30)
        for name in os.listdir(self.dir):
            os.unlink(os.path.join(self.dir, name))
        os.rmdir(self.dir)

