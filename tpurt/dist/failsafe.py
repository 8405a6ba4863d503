"""Failure detection + resumable rendering (SURVEY.md §5 "failure
detection / elastic" row; BASELINE.json has no reference analogue — the
reference is a single-process OpenCL app that simply dies).

Failure model.  In a jax.distributed SPMD job there is no
per-task restart (every host runs the same program and XLA collectives
block until every peer arrives), so the practical v1 toolkit is:

- `heartbeat(mesh)` — a trivial psum across the mesh with a watchdog:
  if any peer is gone/hung the collective never completes and the
  watchdog flags it, instead of the job hanging silently for hours.
- `call_with_retries` — transient-failure retry (runtimes surface flaky
  transfers as exceptions).
- `Watchdog` — a wall-clock bound on any device call.  A hung XLA call
  cannot be cancelled from Python, so on timeout the caller gets
  `WatchdogTimeout` and should exit; completed work is already on disk.
- `render_resumable` — frame rendering in row-slab chunks with a disk
  manifest: a restarted process (same out_dir) skips completed chunks.
  This is the checkpoint/resume story for long renders and animations,
  composing with orbax scene checkpoints (tpurt/utils/checkpoint.py)
  for training loops.
"""
from __future__ import annotations

import concurrent.futures as _futures
import json
import os
import time

import numpy as np


class WatchdogTimeout(RuntimeError):
    """A watched call exceeded its wall-clock budget (likely a hung device
    call or a lost multihost peer).  The call cannot be cancelled from
    Python; restart the process and resume from the chunk manifest."""


class Watchdog:
    """Run calls under a wall-clock bound in a worker thread.

    On timeout the worker thread is abandoned (a hung C/XLA call is not
    interruptible) and `WatchdogTimeout` is raised in the caller — pair
    with `render_resumable` so a process restart loses at most one chunk.
    """

    def __init__(self, timeout_s: float):
        self.timeout_s = float(timeout_s)
        self._pool = _futures.ThreadPoolExecutor(max_workers=1)

    def run(self, fn, *args, **kwargs):
        fut = self._pool.submit(fn, *args, **kwargs)
        try:
            return fut.result(timeout=self.timeout_s)
        except _futures.TimeoutError:
            # leave the worker behind; spin up a fresh one for later calls
            self._pool = _futures.ThreadPoolExecutor(max_workers=1)
            raise WatchdogTimeout(
                f"call exceeded {self.timeout_s:.1f}s wall-clock budget"
            ) from None


def call_with_retries(fn, *args, retries: int = 2, backoff_s: float = 1.0,
                      on_retry=None, **kwargs):
    """Call fn; on exception retry up to `retries` times with linear
    backoff.  WatchdogTimeout is NOT retried (the device is wedged —
    retrying in-process races the abandoned call)."""
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except WatchdogTimeout:
            raise
        except Exception as e:  # noqa: BLE001 — transient runtime errors
            if attempt == retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(backoff_s * (attempt + 1))
    raise AssertionError("unreachable")


_heartbeat_fns: dict = {}


def _heartbeat_fn(mesh):
    """Cached jitted psum probe per mesh: rebuilding the shard_map lambda
    every call defeats the jit cache (a fresh retrace + compile per probe,
    charged against the watchdog)."""
    import jax
    from jax.sharding import PartitionSpec as P

    key = (tuple(d.id for d in mesh.devices.flat), mesh.axis_names)
    f = _heartbeat_fns.get(key)
    if f is None:
        axis = mesh.axis_names[0]
        f = jax.jit(
            jax.shard_map(
                lambda x: jax.lax.psum(x, axis),
                mesh=mesh, in_specs=P(axis), out_specs=P(),
            )
        )
        _heartbeat_fns[key] = f
    return f


def heartbeat(mesh, timeout_s: float = 60.0) -> float:
    """All-peers liveness probe: a psum of ones over the mesh, bounded by
    a watchdog.  Returns the round-trip seconds; raises WatchdogTimeout
    if any peer is gone (the collective blocks forever otherwise)."""
    import jax.numpy as jnp

    f = _heartbeat_fn(mesh)

    def probe():
        t0 = time.perf_counter()
        n = f(jnp.ones((len(mesh.devices.flat),), jnp.int32))
        n.block_until_ready()
        assert int(n[()] if n.ndim == 0 else n[0]) == len(mesh.devices.flat)
        return time.perf_counter() - t0

    return Watchdog(timeout_s).run(probe)


# ---------------------------------------------------------------------------
# resumable chunked rendering
# ---------------------------------------------------------------------------
def _manifest_path(out_dir):
    return os.path.join(out_dir, "manifest.json")


def render_resumable(scene, config, out_dir: str, *, chunk_rows: int = 128,
                     plan=None, mesh=None, timeout_s: float | None = None,
                     retries: int = 2, _fail_after: int | None = None):
    """Render the frame in row-slab chunks, persisting each to `out_dir`;
    a rerun with the same out_dir skips completed chunks and returns the
    assembled image.  `mesh` routes chunks through render_sharded (each
    chunk is itself slab-sharded over the mesh); otherwise single-device
    render_rows.  `_fail_after` injects a crash after N chunks (tests).
    """
    from tpurt.dist.shard import render_rows, render_sharded

    os.makedirs(out_dir, exist_ok=True)
    H, W = config.height, config.width
    n_chunks = -(-H // chunk_rows)
    mpath = _manifest_path(out_dir)
    done: dict[str, str] = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            m = json.load(f)
        if (m["height"], m["width"], m["chunk_rows"]) != (H, W, chunk_rows):
            raise ValueError(
                f"out_dir {out_dir} holds a different render "
                f"({m['height']}x{m['width']} @{m['chunk_rows']}); "
                "use a fresh directory"
            )
        done = m["chunks"]

    wd = Watchdog(timeout_s) if timeout_s is not None else None
    rendered = 0
    for ci in range(n_chunks):
        key = str(ci)
        fpath = os.path.join(out_dir, f"chunk_{ci:05d}.npy")
        if key in done and os.path.exists(fpath):
            continue
        row0 = ci * chunk_rows
        nrows = min(chunk_rows, H - row0)

        def render_chunk(row0=row0, nrows=nrows):
            if mesh is not None:
                img = render_sharded(
                    scene, config, mesh, plan=plan, row0=row0, nrows=nrows
                )
            else:
                img = render_rows(scene, config, row0, nrows, plan=plan)
            return np.asarray(img)

        fn = (lambda: wd.run(render_chunk)) if wd is not None else render_chunk
        chunk = call_with_retries(fn, retries=retries)
        np.save(fpath, chunk)
        done[key] = os.path.basename(fpath)
        with open(mpath, "w") as f:  # manifest updated after EVERY chunk
            json.dump({"height": H, "width": W, "chunk_rows": chunk_rows,
                       "chunks": done}, f)
        rendered += 1
        if _fail_after is not None and rendered >= _fail_after:
            raise RuntimeError(f"injected failure after {rendered} chunks")

    out = np.empty((H, W, 3), np.float32)
    for ci in range(n_chunks):
        row0 = ci * chunk_rows
        nrows = min(chunk_rows, H - row0)
        out[row0 : row0 + nrows] = np.load(
            os.path.join(out_dir, done[str(ci)])
        )[:nrows]
    return out
