"""Process set-up helpers, the pytree dataclass, PNG output and the
in-repo scene files."""

import dataclasses
import os
import struct
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gi_raytracer_tpu import runtime
from gi_raytracer_tpu import struct as gstruct
from gi_raytracer_tpu.io import save_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore the compile-cache settings a test changes."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_uses_env_dir_and_sets_no_other(
        monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_gpu_guard_raises_on_cpu():
    assert runtime.device_info()["platform"] == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()


def _read_png(path):
    """Minimal decoder for the 8-bit RGB, filter-0 PNGs save_png writes."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, (7, 5, 3))
    path = tmp_path / "x.png"
    save_png(str(path), img)
    want = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(_read_png(str(path)), want)
    with pytest.raises(ValueError):
        save_png(str(path), img[..., :2])


@gstruct.dataclass
class _Node:
    x: jnp.ndarray
    y: jnp.ndarray = None
    n: int = gstruct.static_field(default=3)


def test_pytree_dataclass_static_fields_and_replace():
    a = _Node(jnp.ones(2), jnp.zeros(3), n=5)
    leaves, tdef = jax.tree_util.tree_flatten(a)
    assert len(leaves) == 2                      # n is structure, not a leaf
    assert jax.tree_util.tree_unflatten(tdef, leaves).n == 5
    assert tdef != jax.tree_util.tree_structure(a.replace(n=6))
    b = a.replace(x=jnp.full(2, 2.0))
    assert float(b.x[0]) == 2.0 and float(a.x[0]) == 1.0 and b.n == 5
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.x = jnp.zeros(2)
    # None children and static fields survive jit and grad
    f = jax.jit(lambda t: t.x.sum() * t.n)
    assert float(f(_Node(jnp.ones(2)))) == 6.0
    g = jax.grad(lambda t: t.x.sum() * t.n)(_Node(jnp.ones(2), n=4))
    np.testing.assert_array_equal(np.asarray(g.x), [4.0, 4.0])


def test_missing_mesh_is_an_error(tmp_path):
    from gi_raytracer_tpu.scene import load_scene

    scn = tmp_path / "s.scn"
    scn.write_text("colorTex 1 1 1\nmat 0 0 1 1\n"
                   "mesh nowhere.obj 0 0 0 0 0 0 0\n")
    with pytest.raises(FileNotFoundError, match="nowhere.obj"):
        load_scene(str(scn))


def test_cornell_files_match_their_generator(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_cornell", os.path.join(ROOT, "scripts", "make_cornell.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(str(tmp_path))
    for name in ("cornell.scn", "wall.obj"):
        with open(os.path.join(ROOT, "scenes", "cornell", name)) as f:
            assert (tmp_path / name).read_text() == f.read(), name
