"""Launcher: ``python -m hybridbackend_tpu.run [options] script.py ...``.

A JAX re-design of the reference launcher
(``/root/reference/hybridbackend/run.py:65-228``), which spawns one
process per visible GPU and synthesizes per-process ``TF_CONFIG``. In
JAX the unit is one process per *host*, driving all of its GPUs:

* Without ``--simulate``, the launcher demands a GPU and places the
  compile cache (``framework/platform.use_gpu``), initializes
  ``jax.distributed`` where the environment describes a cluster, and
  executes the script.
* ``--simulate N`` locally forks N processes, each with its own
  process_id and a shared coordinator, on CPU devices — the reference's
  per-GPU spawn repurposed for multi-host testing without hardware
  (same role as its test ``Spawn``, ``common/test.py:36-152``).

Failure semantics match the reference (``run.py:215-228``): if any child
exits non-zero, the launcher kills the remaining children and exits
non-zero.
"""

from __future__ import annotations

import argparse
import os
import runpy
import signal
import socket
import subprocess
import sys


def _die_with_parent():
  """Linux: deliver SIGKILL to this child when the launcher dies.

  If the launcher itself is killed (e.g. a test-harness timeout
  SIGKILLs it before its cleanup runs), the simulated workers must not
  orphan — a hung worker would keep the jax.distributed coordinator
  port bound and deadlock every subsequent launch on the host."""
  try:
    import ctypes
    libc = ctypes.CDLL('libc.so.6', use_errno=True)
    libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
  except Exception:  # noqa: BLE001 — best-effort safety net
    pass


def _pick_port() -> int:
  s = socket.socket()
  s.bind(('127.0.0.1', 0))
  port = s.getsockname()[1]
  s.close()
  return port


def _relay_lines(src, dst_fd: int) -> None:
  """Forward each complete line from a child pipe with ONE os.write.

  A single write(2) of <= PIPE_BUF (4096 on Linux) bytes to a pipe is
  atomic, so relayed lines never interleave mid-line across children;
  longer lines are forwarded in PIPE_BUF chunks (only those can split).
  Reading continuously also keeps the child from blocking on a full
  pipe — which is why a downstream write failure (EPIPE: `... | head`
  exited) switches to DISCARDING output rather than abandoning the
  pipe: an undrained child would block forever inside print()."""
  discard = False
  try:
    for line in iter(src.readline, b''):
      if discard:
        continue
      view = memoryview(line)
      while view:
        try:
          n = os.write(dst_fd, view[:4096])
        except OSError:
          discard = True
          break
        view = view[n:]
  except ValueError:  # pipe closed during shutdown
    pass
  finally:
    try:
      src.close()
    except Exception:  # noqa: BLE001
      pass


def _run_script(argv):
  sys.argv = argv
  runpy.run_path(argv[0], run_name='__main__')


def main():
  parser = argparse.ArgumentParser(
      description='hybridbackend_tpu launcher', add_help=True)
  parser.add_argument('--simulate', type=int, default=0, metavar='N',
                      help='fork N local CPU processes (multi-host sim)')
  parser.add_argument('--devices-per-process', type=int, default=1,
                      help='virtual CPU devices per simulated process')
  parser.add_argument('--no-distributed', action='store_true',
                      help='skip jax.distributed.initialize()')
  parser.add_argument('script')
  parser.add_argument('args', nargs=argparse.REMAINDER)
  opts = parser.parse_args()

  if opts.simulate > 0 and 'HB_RUN_PROCESS_ID' not in os.environ:
    port = int(os.environ.get('HB_RUN_BASE_PORT', 0)) or _pick_port()
    coord = f'127.0.0.1:{port}'
    procs = []
    for rank in range(opts.simulate):
      env = dict(os.environ)
      env.update({
          'HB_RUN_PROCESS_ID': str(rank),
          'HB_RUN_NUM_PROCESSES': str(opts.simulate),
          'HB_RUN_COORDINATOR': coord,
          'JAX_PLATFORMS': 'cpu',
          'XLA_FLAGS': (env.get('XLA_FLAGS', '') +
                        f' --xla_force_host_platform_device_count='
                        f'{opts.devices_per_process}').strip(),
      })
      flags = ['--devices-per-process', str(opts.devices_per_process)]
      if opts.no_distributed:
        flags.append('--no-distributed')
      procs.append(subprocess.Popen(
          [sys.executable, '-m', 'hybridbackend_tpu.run', *flags,
           opts.script] + opts.args, env=env,
          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
          preexec_fn=_die_with_parent if sys.platform.startswith('linux')
          else None))
    # Per-child pipes + an atomic line relay. Children MUST NOT share
    # the launcher's stdout directly: even line-buffered, a child's
    # 8 KB BufferedWriter can hit its boundary MID-line and emit the
    # fragment as its own write(2), interleaving with a peer's line
    # (captured in the wild: 'FINALFINAL 0 ...\n 1 ...'). The relay
    # reads complete lines from each child and forwards each with one
    # os.write — atomic on pipes up to PIPE_BUF.
    import threading
    relays = []
    for p in procs:
      for src, dst in ((p.stdout, 1), (p.stderr, 2)):
        t = threading.Thread(target=_relay_lines, args=(src, dst),
                             daemon=True)
        t.start()
        relays.append(t)
    import time
    code = 0
    try:
      # Poll all children so any failure is noticed immediately and the
      # rest are killed (reference run.py:215-228 semantics).
      live = list(procs)
      while live and code == 0:
        for p in list(live):
          rc = p.poll()
          if rc is None:
            continue
          live.remove(p)
          code = code or rc
        time.sleep(0.1)
    finally:
      for p in procs:
        if p.poll() is None:
          p.send_signal(signal.SIGTERM)
      deadline = time.time() + 10.0
      for p in procs:
        try:
          p.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
          p.kill()  # a TERM-ignoring wedge must not hang the launcher
          p.wait()
      # Drain trailing output before exiting (EOF after child death).
      for t in relays:
        t.join(timeout=5.0)
    sys.exit(code)

  # Child (or direct) execution path.
  if 'HB_RUN_PROCESS_ID' in os.environ:
    # All children share the parent's stdout fd. When that fd is a pipe
    # (CI capture), the default BLOCK buffering flushes at arbitrary
    # byte boundaries, so two ranks' log lines can interleave mid-line.
    # Line buffering makes each complete line one write(2) — atomic on
    # pipes up to PIPE_BUF — so per-rank lines stay intact.
    try:
      sys.stdout.reconfigure(line_buffering=True)
      sys.stderr.reconfigure(line_buffering=True)
    except (AttributeError, ValueError):  # non-standard stream objects
      pass
    # Liveness instrumentation: a wedged child must self-report. SIGUSR2
    # dumps all thread stacks on demand; HB_RUN_FAULT_TIMEOUT=<seconds>
    # dumps-and-exits if the child is still alive after the deadline
    # (reference failure semantics: a hung worker must surface, not
    # stall the job — run.py:215-228).
    import faulthandler
    try:
      faulthandler.register(signal.SIGUSR2, all_threads=True)
    except Exception:  # noqa: BLE001 — platform-dependent
      pass
    fto = os.environ.get('HB_RUN_FAULT_TIMEOUT')
    if fto:
      faulthandler.dump_traceback_later(float(fto), exit=True)
  if not opts.no_distributed:
    import jax
    if 'HB_RUN_PROCESS_ID' in os.environ:
      # Simulated children must run on CPU (see framework/platform.py).
      from hybridbackend_tpu.framework.platform import force_host_devices
      force_host_devices(opts.devices_per_process)
      jax.distributed.initialize(
          coordinator_address=os.environ['HB_RUN_COORDINATOR'],
          num_processes=int(os.environ['HB_RUN_NUM_PROCESSES']),
          process_id=int(os.environ['HB_RUN_PROCESS_ID']))
    else:
      try:
        jax.distributed.initialize()
      except Exception:  # single-process / no cluster metadata
        pass
  if 'HB_RUN_PROCESS_ID' not in os.environ:
    # After jax.distributed, which must precede backend initialization.
    from hybridbackend_tpu.framework.platform import use_gpu
    use_gpu()
  try:
    _run_script([opts.script] + opts.args)
  finally:
    # Orderly coordination teardown on EVERY exit path (success,
    # exception, sys.exit): letting the interpreter exit with a live
    # client has aborted children (C++ terminate) when background RPCs
    # raced the client destructor — and on the exception path that
    # SIGABRT would mask the real traceback.
    if not opts.no_distributed and 'HB_RUN_PROCESS_ID' in os.environ:
      try:
        import jax
        jax.distributed.shutdown()
      except Exception:  # noqa: BLE001 — already shut down / never up
        pass


if __name__ == '__main__':
  main()
