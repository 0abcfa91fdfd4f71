"""chip_smoke.py on the CPU: the script refuses any platform but the GPU,
and each of its phases runs end to end at toy size by direct call (the
full-size run is `python chip_smoke.py` on the card)."""

import jax
import pytest

import chip_smoke


def test_main_refuses_the_cpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four-cards"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_phase_a_toy():
    errors = chip_smoke.phase_a(num_points=60, num_images=6)
    assert set(errors) >= {"points rel", "sigma0 rel", "Qxx diag rel"}
    assert all(e <= t for e, t in errors.values())


def test_phase_b_toy():
    errors = chip_smoke.phase_b(num_points=512, num_images=24, views=8,
                                n_cov=32)
    assert set(errors) == {"max|dpoint|", "sigma0^2 rel",
                           "non-finite cov blocks", "cov Frobenius rel"}
    assert all(e <= t for e, t in errors.values())


def test_four_cards_on_virtual_devices():
    if len(jax.devices()) < 4:
        pytest.fail("conftest provides 8 virtual CPU devices")
    errors = chip_smoke.phase_four_cards(4, num_points=256, num_images=10,
                                         views=4)
    assert len(errors) == 6
    assert all(e <= t for e, t in errors.values())


def test_cli_parses_without_a_device_option(monkeypatch):
    """The CLI runs on the backend JAX picks: it has no device option, and
    --f32 only chooses the precision."""
    from bundle_adjustment_tpu import __main__ as cli

    seen = {}

    def stop(args):
        seen.update(vars(args))
        raise SystemExit(0)

    monkeypatch.setattr(cli, "_configure_backend", stop)
    with pytest.raises(SystemExit) as exc:
        cli.main(["report", "some.htm", "--f32"])
    assert exc.value.code == 0
    assert seen["f32"] is True
    assert set(seen) == {
        "command", "path", "inversion", "simulation", "damping",
        "max_iterations", "no_centroid", "export", "export_mat",
        "checkpoint", "resume", "datum_name_length", "quiet", "f32"}
