"""The CUDA packed-key scan kernel against its plain torch version.

Needs a CUDA card (marker ``gpu``; skipped elsewhere).  Imports no JAX,
so it runs on a machine that has only PyTorch:

    python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: none — int32 keys are bit-exact.  One test item, for the
reason given in tests/test_torch_scan.py.
"""

import numpy as np
import pytest
import torch

from instant_distance_tpu_torch.ops import scan_kernel as tsk

pytestmark = pytest.mark.gpu

#: (B, D, N, lsub, cb, groups)
CASES = (
    (1024, 128, 65536, 64, 8192, 0),     # the main path's shapes
    (1024, 128, 65536, 64, 8192, 2),
    (100, 20, 4096, 16, 1024, 4),        # ragged batch, D % 32 != 0
    (7, 3, 512, 8, 64, 0),
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(b, d, n, lsub, cb, seed, device):
    g = torch.Generator().manual_seed(seed)
    qc = torch.randint(-127, 128, (b, d), generator=g, dtype=torch.int8)
    codes = torch.randint(-127, 128, (d, n), generator=g, dtype=torch.int8)
    norms = torch.rand((1, n), generator=g) * 4
    norms[0, -3 * n // 64:] = torch.inf
    eligible = torch.rand((1, n), generator=g) < 0.9
    w2 = tsk.pack_w2(norms, torch.tensor(2 * 0.011 * 0.019), eligible,
                     lsub=lsub, cb=cb, d=d)
    return qc.to(device), w2.to(device), codes.to(device)


def test_kernel_matches_plain(cuda):
    for b, d, n, lsub, cb, groups in CASES:
        qc, w2, codes = _operands(b, d, n, lsub, cb, seed=n + d, device=cuda)
        before = tsk.launches
        got = tsk.fused_scan_bucket_int_packed(qc, w2, codes, lsub=lsub,
                                               cb=cb, groups=groups)
        torch.cuda.synchronize()
        assert tsk.launches == before + 1
        want = tsk.fused_scan_bucket_int_packed_plain(
            qc, w2, codes, lsub=lsub, cb=cb, groups=groups)
        if groups <= 1:
            got, want = (got,), (want,)
        for g_, w_ in zip(got, want):
            np.testing.assert_array_equal(
                g_.cpu().numpy(), w_.cpu().numpy(),
                err_msg=f"B={b} D={d} N={n} lsub={lsub} cb={cb} "
                        f"groups={groups}")

    # malformed operands raise instead of reaching the kernel
    qc, w2, codes = _operands(8, 16, 512, 8, 64, seed=0, device=cuda)
    with pytest.raises(ValueError, match="device"):
        tsk.fused_scan_bucket_int_packed(qc.cpu(), w2, codes, lsub=8, cb=64)
    with pytest.raises(ValueError, match="contiguous"):
        tsk.fused_scan_bucket_int_packed(qc, w2, codes.T.contiguous().T,
                                         lsub=8, cb=64)
