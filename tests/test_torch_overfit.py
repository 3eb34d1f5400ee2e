"""The port's trainer-validation tool (`abx_tpu_torch/tools/overfit_6ct7.py`)
at a tiny size on the CPU: two training steps on testdata/6ct7_H_L_S.pdb,
then the EMA weights' H3 samples in f32 and bf16 at the same seed."""

import csv
import json
import math

from abx_tpu_torch.tools import overfit_6ct7


def test_overfit_tool_writes_metrics_and_result(tmp_path):
    overfit_6ct7.main(['--tiny', '--steps', '2', '--batch', '1', '--num_t',
                       '2', '--num_samples', '1', '--device', 'cpu',
                       '--out', str(tmp_path)])
    with open(tmp_path / 'metrics.csv', newline='', encoding='utf-8') as f:
        rows = list(csv.DictReader(f))
    assert [int(r['step']) for r in rows] == [2]
    assert math.isfinite(float(rows[0]['total']))
    with open(tmp_path / 'result.json', encoding='utf-8') as f:
        result = json.load(f)
    assert result['train']['steps'] == 2 and result['tiny']
    assert result['train']['loss_last']['total'] == float(rows[0]['total'])
    for dtype in ('f32', 'bf16'):
        ev = result['eval'][dtype]
        assert ev['n'] == 1 and len(ev['samples']) == 1
        assert math.isfinite(ev['h3_rmsd_mean'])
        assert 0.0 <= ev['h3_aar_mean'] <= 1.0
    delta = result['eval']['bf16_minus_f32'][0]
    assert delta['h3_rmsd'] == (result['eval']['bf16']['h3_rmsd_mean']
                                - result['eval']['f32']['h3_rmsd_mean'])
    assert (tmp_path / 'params.pt').exists()
