"""The port's TEAT-GT train CLI against ``vidsgg``'s with TokenGT's random
node identifiers: ``teatgt_train --mode predcls --rand_node_id`` and
``--orf_node_id``, as ``test_torch_teatgt_train_cli_modes.py:check_runs``
compares its modes (both CLIs in float64 over 2 videos x 1 epoch, the
port handed ``vidsgg``'s draws: the ``rand`` identifiers of every train
step through ``SharedNoise`` and of validation through ``JaxFixedDraws``,
the ``orf`` matrices of both through ``DrawBridge``)."""

import pytest
from test_torch_teatgt_train_cli_modes import check_runs


@pytest.mark.parametrize("flag", ["--rand_node_id", "--orf_node_id"])
def test_train_cli_matches_vidsgg(flag, tmp_path):
    state = check_runs("predcls", [flag], tmp_path, pytest.MonkeyPatch())
    ids = state.model.TokenGT_encoder.graph_encoder.graph_feature
    assert ids.id_encoder_name == f"{flag[2:].split('_')[0]}_encoder"
