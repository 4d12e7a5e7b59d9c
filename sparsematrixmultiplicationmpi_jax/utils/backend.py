"""Backend introspection shared by the kernel dispatchers.

Every dispatch site asks :func:`platform` which backend the program runs
on: ``"gpu"`` takes the compiled GPU kernel or the XLA path, ``"cpu"``
takes the XLA path (a Pallas kernel runs there in interpret mode only
when a caller asks for it explicitly). Any other platform is an error,
and so is a failing device probe: a broken GPU runtime must never be
mistaken for a CPU run.
"""

from __future__ import annotations

import jax

__all__ = ["platform", "SUPPORTED_PLATFORMS"]

SUPPORTED_PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """``jax.devices()[0].platform`` — ``"gpu"`` or ``"cpu"``.

    Raises ``RuntimeError`` for any other platform; the device probe's own
    exception propagates unchanged."""
    name = jax.devices()[0].platform
    if name not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}; this program runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}")
    return name
