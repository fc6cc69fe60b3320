"""Host-side compute scope.

Graph construction, initialization, and other per-factor bookkeeping evaluate
small eager jnp expressions (manifold compose/exp/log on single points). On an
accelerator each such op is a kernel launch plus a transfer back to the host
for a few scalars, and the graph builder issues thousands of them in
sequence. These are host-side code paths by design, so pin them to the CPU
backend; the solver's batched/jitted programs are unaffected and stay on the
accelerator.
"""

from __future__ import annotations

import contextlib
import functools


@contextlib.contextmanager
def host_default_device():
    """Context that makes eager jnp ops execute on the host CPU backend."""
    import jax

    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:  # pragma: no cover — no CPU backend registered
        yield
        return
    with jax.default_device(cpu):
        yield


def on_host(fn):
    """Decorator form of :func:`host_default_device`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with host_default_device():
            return fn(*args, **kwargs)

    return wrapped
