"""Test harness config: an 8-virtual-device CPU JAX platform by default.

Sharding tests run on a virtual 8-device CPU mesh
(``--xla_force_host_platform_device_count=8``).  This must run before any
test module touches a JAX backend; keep it at the top of conftest, before
other imports that might pull in jax.

``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the tests marked
``gpu`` on a GPU instead; everywhere else they skip.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
# CLI modules (demo.py, bench.py, ...) call enable_compilation_cache() at
# import, and several tests exec them; the persistent cache must stay OFF
# in the suite — XLA:CPU's executable serialization segfaults writing some
# programs (observed r5 on the bf16 structured train_step), and tests gain
# nothing from a disk cache.  enable_compilation_cache honors this switch.
os.environ["GFT_COMPILE_CACHE"] = "0"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
# Parity tests compare against the float64 reference; all float32 code paths
# pass explicit dtypes, so enabling x64 session-wide is safe.
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jit_caches_between_modules():
    """This jaxlib's XLA:CPU backend segfaults compiling a large program
    late in a long session (observed r5: whichever MAPPO train_step
    compile lands around the ~165th test, while the same test passes
    standalone).  Dropping the accumulated executables between modules
    keeps the backend under the crash threshold; within-module caching
    still amortizes compiles."""
    yield
    jax.clear_caches()
