"""The device-decode flag: ``--device-decode`` parses for ``track`` and
``run-live`` and is off by default."""
import pytest

from vision_basedsensor_tpu.cli import main as cli


@pytest.mark.parametrize("cmd,argv", [
    ("cmd_track", ["track", "video.avi", "--device-decode"]),
    ("cmd_run_live", ["run-live", "http://127.0.0.1:8081/stream",
                      "--device-decode"]),
])
def test_device_decode_flag_parses(monkeypatch, cmd, argv):
    seen = {}
    monkeypatch.setattr(cli, cmd, lambda args: seen.update(vars(args)))
    cli.main(argv)
    assert seen["device_decode"] is True


@pytest.mark.parametrize("argv", [["track", "video.avi"],
                                  ["run-live", "http://127.0.0.1:1/s"]])
def test_device_decode_defaults_off(monkeypatch, argv):
    seen = {}
    for cmd in ("cmd_track", "cmd_run_live"):
        monkeypatch.setattr(cli, cmd, lambda args: seen.update(vars(args)))
    cli.main(argv)
    assert seen["device_decode"] is False

