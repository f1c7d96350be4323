"""Build the native host library: ``python -m epsilon_tpu.native.build``."""

import os
import subprocess
import sys
import tempfile

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ["tv1d.cc", "ordering.cc"]
OUT = os.path.join(SRC_DIR, "libepsilon_native.so")


def build(verbose: bool = True) -> str:
    """Compile into a temporary file beside ``OUT`` and rename it into
    place, so concurrent builds (test workers) never load a half-written
    library."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=SRC_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
           "-o", tmp] + [os.path.join(SRC_DIR, s) for s in SOURCES]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, OUT)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return OUT


if __name__ == "__main__":
    build()
    print(f"built {OUT}")
    sys.exit(0)
