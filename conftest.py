import os

# Tests always run on a virtual 8-device CPU mesh (JAX_PLATFORMS=cpu);
# device runs go through chip_smoke.py and bench.py.
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
os.environ["JAX_PLATFORMS"] = "cpu"

import subprocess  # noqa: E402

# Build the native artifacts up front so their tests run instead of
# skipping (libntpu_io.so for the fastx reader, libntedit_repair.so for
# the repair engine, ntedit_baseline for the scalar C++ baseline, and
# reference_ntedit — the unmodified reference engine compiled against the
# btllib shim, needs /root/reference present).  Binaries are NOT version-
# controlled (only sources are); a failed build leaves the skips in place.
_native = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
if os.path.isdir(_native):
    for _tgt, _timeout in (
        ("libntpu_io.so", 180), ("libntedit_repair.so", 180),
        ("ntedit_baseline", 120), ("reference_ntedit", 180),
    ):
        try:
            subprocess.run(
                ["make", "-C", _native, _tgt],
                check=False, capture_output=True, timeout=_timeout,
            )
        except Exception:
            pass
