"""chip_smoke.py's phases at test sizes on the CPU, called directly
(past the GPU gate that main() applies): the control flow, the checks
and the parity bounds of the on-card proof, without the card."""

import json

import pytest

import chip_smoke as cs


@pytest.fixture
def smoke(tmp_path):
    return cs.Smoke(cs.TINY, "cpu-test", str(tmp_path))


def test_phase_device_reports(capsys):
    cs.phase_device("cpu-test")
    out = capsys.readouterr().out
    assert "'platform': 'cpu'" in out
    assert "cpu-test" in out and "compile cache" in out


def test_phase_compile(smoke, capsys):
    smoke.phase_compile()
    out = capsys.readouterr().out
    assert out.count("memory_analysis") == 3


def test_phase_parity(smoke, capsys):
    smoke.phase_parity()
    out = capsys.readouterr().out
    for tag in ("(a)", "(b)", "(c)", "(d)"):
        assert f"parity {tag}" in out
    # the precision control: HIGHEST checked, DEFAULT printed
    assert "control: MRT K @ f_neq at HIGHEST" in out
    assert "control: MRT K @ f_neq at DEFAULT" in out


def test_phase_main_path(smoke, capsys):
    smoke.phase_main_path()
    out = capsys.readouterr().out
    assert "MLUPS live" in out and "tree-sparse steady" in out


def test_phase_clinical(smoke, capsys):
    smoke.phase_clinical()
    out = capsys.readouterr().out
    assert "transport --coupled" in out and "Nu [" in out


def test_phase_copy_floor(smoke, capsys):
    smoke.phase_copy_floor()
    out = capsys.readouterr().out
    assert "step / copy" in out and "distinct device ops" in out


def test_phase_four_on_virtual_devices(smoke, capsys):
    smoke.phase_four(4)
    out = capsys.readouterr().out
    assert "parity GSPMD" in out and "parity halo" in out


def test_parity_check_raises_past_bound():
    cs.check_parity("inside", 0.5e-5)
    with pytest.raises(AssertionError):
        cs.check_parity("outside", 2e-5)
    with pytest.raises(AssertionError):
        cs.check_parity("nan", float("nan"))


def test_clinical_opts_reach_the_cli_as_json(smoke):
    """The CLI parses each --opt value as JSON; the composition must
    survive that round trip unchanged."""
    opts = smoke.clinical_opts()
    args = cs.Smoke._opt_args(opts)
    assert args[0] == "--opt"
    back = {a.split("=", 1)[0]: json.loads(a.split("=", 1)[1])
            for a in args[1:]}
    assert back == opts
    assert len(back["windkessel"]) == 4
    assert back["rheology"]["model"] == "carreau"


@pytest.mark.gpu
def test_card_label_on_gpu(gpu_device):
    label = cs.card_label()
    assert "," in label
