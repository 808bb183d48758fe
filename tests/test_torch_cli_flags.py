"""The test CLIs' handling of ``--data_parallel``, ``--pair_detect`` and
``--max_videos`` against ``vidsgg``'s: where ``vidsgg``'s TEMPURA CLI
serves on one device despite those flags, the port prints the same NOTEs
and serves the same (one synthetic video each, the same weights carried
across, the comparisons and tolerances of ``test_torch_cli.py``); on one
device, sgdet's ``--data_parallel 2`` says so and serves.
"""

import re

import pytest
from cli_parity_utils import (
    TEMPURA_FLAGS,
    assert_same_preds,
    assert_same_run,
    pickles,
    run_port_tempura,
    run_vidsgg_tempura,
    synthetic_head,
)

import vidsgg_torch.cli.tempura_test as tcli


@pytest.mark.parametrize("mode,flags,notes", [
    ("predcls", ["--data_parallel", "2"], 1),
    ("predcls", ["--pair_detect", "2"], 0),
    ("sgcls", ["--data_parallel", "2"], 1),
    ("sgcls", ["--pair_detect", "2"], 0),
    ("sgdet", ["--max_videos", "1", "--data_parallel", "2"], 1),
    ("sgdet", ["--max_videos", "1", "--pair_detect", "2"], 1),
])
def test_serving_flags_match_vidsgg(mode, flags, notes, tmp_path, monkeypatch, capsys):
    """Where ``vidsgg``'s CLI serves on one device despite --data_parallel
    or --pair_detect, the port prints the same NOTEs and serves the same."""
    argv = ["--mode", mode, "--synthetic", "1"] + TEMPURA_FLAGS + flags
    jax_evs, jax_out, jax_run = run_vidsgg_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "jax")])
    synthetic_head(monkeypatch)
    port_evs, port_out, _, port_preds = run_port_tempura(
        monkeypatch, capsys, argv + ["--output_path", str(tmp_path / "port")], jax_run)
    assert len(re.findall(r"^NOTE: ", port_out, re.M)) == notes
    assert_same_run(jax_evs, jax_out, port_evs, port_out)
    assert_same_preds(port_preds, jax_run["preds"])
    assert pickles(tmp_path / "port") == pickles(tmp_path / "jax")


def test_sgdet_data_parallel_on_one_device_serves(tmp_path, capsys):
    """sgdet --data_parallel 2 without --max_videos: ``vidsgg`` shards over
    the devices it finds; on one device it says so and serves, and so does
    the port."""
    evs = tcli.main(["--mode", "sgdet", "--synthetic", "1", "--device", "cpu",
                     "--data_parallel", "2", "--output_path", str(tmp_path)] + TEMPURA_FLAGS)
    out = capsys.readouterr().out
    assert "NOTE: only 1 devices available; --data_parallel 2 -> 1" in out
    assert re.search(r"^evaluated 1 videos", out, re.M)
    assert len(evs) == 3
