"""perfbench/served.py whose process has loaded a module under a name of
the JAX stack, as a lazy import on the serve path would."""

import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from perfbench import served  # noqa: E402

if __name__ == "__main__":
    sys.modules["jax"] = types.ModuleType("jax")
    sys.exit(served.main())
