"""ark_tpu enables JAX's persistent compilation cache by default.

The pipeline programs take seconds to minutes each to compile, and the
cache lets a fresh process reuse them. These tests pin the precedence
contract of `ark_tpu._default_compile_cache` via fresh subprocesses (the
config is process-global and sticky): JAX_COMPILATION_CACHE_DIR when set,
else `<checkout>/.xla_cache`, and ARK_TPU_XLA_CACHE only switches it off.
HOME is pointed at tmp_path to show the default does not depend on it."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# jax first (already imported by the application), then ark_tpu configures it
_JAX_FIRST = (
    "import jax; jax.config.update('jax_platforms', 'cpu')\n"
    "import ark_tpu\n"
    "print(repr(jax.config.jax_compilation_cache_dir))\n"
)
# ark_tpu first: must NOT import jax (users set JAX_PLATFORMS after it);
# the default arrives via jax's own env var at the later jax import. Runs
# under `python -S` so no site hook can import jax first (site-packages is
# re-added by hand, without executing sitecustomize).
_SITE = __import__("sysconfig").get_paths()["purelib"]
_ARK_FIRST = (
    "import sys\n"
    f"sys.path.append({_SITE!r})  # venv site-packages (no site processing)\n"
    "import ark_tpu\n"
    "assert 'jax' not in sys.modules, 'import ark_tpu must not import jax'\n"
    "import jax\n"
    "print(repr(jax.config.jax_compilation_cache_dir))\n"
)


def _probe(extra_env, tmp_path, code=_JAX_FIRST, no_site=False):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("ARK_TPU_XLA_CACHE", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["HOME"] = str(tmp_path)  # the default must not depend on HOME
    env.update(extra_env)
    argv = [sys.executable] + (["-S"] if no_site else []) + ["-c", code]
    res = subprocess.run(argv, env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout.strip().splitlines()[-1]


def _default_dir(tmp_path):
    return repr(os.path.join(REPO, ".xla_cache"))


def test_default_cache_dir_enabled(tmp_path):
    assert _probe({}, tmp_path) == _default_dir(tmp_path)


def test_ark_first_defers_jax_and_still_caches(tmp_path):
    # ark_tpu imported before jax: no eager jax import, env-var seeding
    assert _probe({}, tmp_path, code=_ARK_FIRST,
                  no_site=True) == _default_dir(tmp_path)


def test_knob_disables(tmp_path):
    for off in ("0", "false", "OFF", "no", ""):
        assert _probe({"ARK_TPU_XLA_CACHE": off}, tmp_path) == "None", off


def test_knob_overrides_path(tmp_path):
    # the knob is an off switch only: any other value keeps the checkout
    # default, so no second place in code can name a cache directory
    target = str(tmp_path / "my_cache")
    assert _probe({"ARK_TPU_XLA_CACHE": target},
                  tmp_path) == _default_dir(tmp_path)
    assert not os.path.exists(target)


def test_jax_env_var_wins(tmp_path):
    # jax's own env var configures the cache at jax-config level; ark_tpu
    # must not override it
    target = str(tmp_path / "jax_cache")
    assert _probe({"JAX_COMPILATION_CACHE_DIR": target},
                  tmp_path) == repr(target)


_FLAGS = "import os, ark_tpu\nprint(os.environ.get('XLA_FLAGS', ''))\n"


def test_import_leaves_xla_flags_alone(tmp_path):
    # XLA flags are the launcher's choice: run-to-run determinism on the
    # GPU (`--xla_gpu_deterministic_ops`) costs several times the
    # segmentation stage's time, so the package does not set it
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    out = _probe(env, tmp_path, code=_FLAGS)
    assert out == "--xla_force_host_platform_device_count=2"
