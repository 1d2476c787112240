"""The compile-cache rule (utils/cache.py): JAX_COMPILATION_CACHE_DIR, when
set, is used as is; otherwise one fixed path in the checkout. Only the
helper ever sets the directory, so no entry point can override the
environment."""
import os
import subprocess
import sys

import pytest

from vision_basedsensor_tpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax; from vision_basedsensor_tpu.utils.cache import "
          "enable_compile_cache; d = enable_compile_cache(); "
          "print(d); print(jax.config.jax_compilation_cache_dir)")


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items() if k != cache.ENV_VAR}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env[cache.ENV_VAR] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    return out[-2], out[-1]


def test_env_var_is_used_as_is(tmp_path):
    returned, configured = _probe(str(tmp_path / "cc"))
    assert returned == configured == str(tmp_path / "cc")


def test_unset_env_uses_fixed_checkout_path():
    returned, configured = _probe(None)
    assert returned == configured == os.path.join(ROOT, ".jax_cache")


def test_installed_copy_uses_user_cache(tmp_path, monkeypatch):
    real_exists = os.path.exists
    monkeypatch.setattr(os.path, "exists",
                        lambda p: False if p.endswith("pyproject.toml")
                        else real_exists(p))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert cache.default_cache_dir() == os.path.join(
        str(tmp_path), "vision_basedsensor_tpu", "jax")


@pytest.mark.parametrize("path", ["bench.py", "chip_smoke.py",
                                  "vision_basedsensor_tpu/cli/main.py",
                                  "tests/conftest.py",
                                  "vision_basedsensor_tpu/utils/cache.py"])
def test_only_the_helper_sets_the_cache_dir(path):
    src = open(os.path.join(ROOT, path)).read()
    sets_dir = '"jax_compilation_cache_dir"' in src
    assert sets_dir == path.endswith("utils/cache.py")
    if not path.endswith("utils/cache.py"):
        assert "enable_compile_cache" in src
