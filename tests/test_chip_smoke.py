"""chip_smoke.py's phases at a tiny size on the CPU: the same code paths
and checks the card run takes at full size."""

import json

import numpy as np
import jax
import pytest

import chip_smoke as cs


@pytest.fixture(scope="module")
def cornell():
    ls, cam = cs.phase_scene()
    batch, pm = cs.phase_photons(ls, 2000)
    return ls, cam, batch, pm


def test_refuses_to_run_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_scene_and_photon_phases(cornell, capsys):
    ls, _, batch, pm = cornell
    assert ls.scene.n_tris == 2250 and ls.scene.n_spheres == 2
    assert int(np.asarray(batch.stored).sum()) >= 0.99 * 2000
    assert pm.capacity == 2000


def test_trace_phase_agrees_with_brute_force(cornell, capsys):
    ls, cam, _, _ = cornell
    ro, rd, hit = cs.phase_trace(ls, cam, 48, 48)
    assert ro.shape == (48 * 48, 3)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "trace" and line["primary_prim_agree"] >= 0.999


def test_knn_phase_matches_float64(cornell, capsys):
    ls, cam, _, pm = cornell
    ro, rd, hit = cs.phase_trace(ls, cam, 32, 32)
    cs.phase_knn(ls, pm, ro, rd, hit, n_ref=256)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "knn" and line["rel_err_chunkrow"] <= 1e-3


def test_render_phases(cornell, tmp_path, capsys):
    ls, cam, _, pm = cornell
    png = tmp_path / "frame.png"
    cs.phase_render(ls, cam, pm, 32, 1, 3, str(png))
    assert png.stat().st_size > 0
    cs.phase_render_cpu(ls, cam, pm, 16, 1, 2)


def test_cli_phase(tmp_path, capsys):
    cs.phase_cli(str(tmp_path), 16, 500)
    out = capsys.readouterr().out
    assert out.startswith("[device] platform=cpu")


def test_grad_phase(cornell, capsys):
    ls, cam, batch, _ = cornell
    cs.phase_grad(ls, cam, batch, 16, 3, 1000)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "grad" and all(g > 0 for g in line["grad_norms"])


def test_four_phase_on_virtual_devices(cornell, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    ls, cam, _, _ = cornell
    cs.phase_four(ls, cam, 4, size=64, spp=1, depth=2, photons=400,
                  grad_size=16)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "four" and line["stored_identical"]
