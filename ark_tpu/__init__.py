"""ark_tpu — a multiplexed-imaging analysis framework on JAX accelerators.

A ground-up JAX/XLA rebuild of the capabilities of angelolab/ark-analysis
(reference layout: src/ark/{phenotyping,segmentation,analysis,spLDA,utils}).

Design stance (see SURVEY.md §7):
  * arrays-first core: pure functions over jnp arrays; pandas only at API edges
  * hot kernels (SOM BMU search, blur, segment reductions, pairwise distances)
    are jitted XLA programs; the same code runs on the GPU and, for tests,
    on the CPU
  * cohort scale-out is FOV-sharded data parallelism over a jax.sharding.Mesh
  * disk IO isolated in ark_tpu.io with async host prefetch
"""

__version__ = "0.1.0"

import os as _os
import sys as _sys

_CACHE_OFF = ("0", "", "false", "off", "no")
_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def _default_compile_cache():
    """Enable JAX's persistent compilation cache unless configured away.

    Pipeline programs (Mesmer forward, fused pixel pipeline, SOM scans)
    take seconds to minutes each to compile; the cache lets a fresh process
    reuse them. Precedence: an explicit JAX_COMPILATION_CACHE_DIR (jax's
    own env var) or a prior jax.config.update always wins, and nothing here
    sets another directory then; ARK_TPU_XLA_CACHE=0/false/off/no (or
    empty) disables the cache; otherwise it lives in `<checkout>/.xla_cache`
    (listed in .gitignore). Cache keys include platform + compile options,
    so CPU and GPU runs never collide.

    Importing ark_tpu must NOT import jax itself: users (and this repo's
    own conftest) rely on setting JAX_PLATFORMS/XLA_FLAGS between
    `import ark_tpu` and their first jax import, and an eager jax import
    would bake the session defaults in. So: if jax is already loaded, set
    the config directly; otherwise seed jax's own env var, which jax reads
    whenever it is first imported."""
    knob = _os.environ.get("ARK_TPU_XLA_CACHE")
    if knob is not None and knob.strip().lower() in _CACHE_OFF:
        return
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    path = _os.path.join(_CHECKOUT, ".xla_cache")
    try:
        _os.makedirs(path, exist_ok=True)
    except OSError:  # read-only checkout etc. — cache is best-effort
        return
    if "jax" in _sys.modules:
        jax = _sys.modules["jax"]
        if not jax.config.jax_compilation_cache_dir:  # app config wins
            jax.config.update("jax_compilation_cache_dir", path)
    else:
        _os.environ["JAX_COMPILATION_CACHE_DIR"] = path


_default_compile_cache()

from ark_tpu import settings  # noqa: F401,E402
