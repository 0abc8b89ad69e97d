"""Which accelerator a measurement ran on.

Every number the bench and the smoke run print names the card it came
from: JAX's platform, device kind and device count, plus the card's name
and power limit as nvidia-smi reports them (a card set below its maximum
power runs slower under load, so the limit belongs beside each time).
"""

from __future__ import annotations

import subprocess

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def smi_line() -> str:
    """First line of `nvidia-smi --query-gpu=name,power.limit`, or "" when
    nvidia-smi is missing or fails (e.g. on a host with no card)."""
    try:
        out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else ""


def parse_smi_line(line: str) -> tuple[str, str]:
    """"NVIDIA H100 80GB HBM3, 700.00 W" -> ("NVIDIA H100 80GB HBM3",
    "700.00 W").  The name may itself hold commas; the limit is the last
    field."""
    name, sep, limit = line.rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unrecognised nvidia-smi line: {line!r}")
    return name.strip(), limit.strip()


def require_gpu():
    """JAX's devices, or SystemExit(2) unless the first one is a GPU.

    A measurement or a chip check that finds no card fails; it never falls
    back to the CPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this program measures on a GPU only")
    return devs


def device_record(devices) -> dict:
    """The device fields every result line carries; `devices` are the ones
    the measurement used, not every one visible."""
    name, limit = parse_smi_line(smi_line())
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "card": name, "power_limit": limit}
