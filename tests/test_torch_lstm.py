"""The summation order of the LSTM recurrence kernel (csrc/lstm.cu).

The kernel forms each gate sum h . W_hh[row] in its own order: lane l of a
warp holds k = 4 l + 128 c + e (c < ceil(H / 128), e < 4) and accumulates
those products with fused multiply-adds in (c, e) order; the warp then adds
the 32 lane sums pairwise across lane bits 4, 3, 2, 1, 0 in turn, and
gates_x is added last. The kernel cannot run here; this test emulates that
order (products exact, each fused add rounded once to f32) over the main
path's 750 steps at B = 4, H = 512, and holds the result against the plain
loop within the smoke phase's LSTM_TOL.
"""

import numpy as np
import torch

from neuralcodecs_tpu_torch.ops.kernels.lstm import lstm_scan_plain

LSTM_TOL = dict(rtol=1e-5, atol=1e-6)


def _kernel_order_scan(gates_x, w_hh, h0, c0):
    t_len, b, four_h = gates_x.shape
    h_dim = four_h // 4
    nc = -(-h_dim // 128)
    kp = 128 * nc
    w = torch.zeros(four_h, kp, dtype=torch.float64)
    w[:, :h_dim] = w_hh.double()
    w = w.reshape(four_h, nc, 32, 4)                      # [row, c, lane, e]
    h, c = h0, c0
    ys = []
    for t in range(t_len):
        hp = torch.zeros(b, kp, dtype=torch.float64)
        hp[:, :h_dim] = h.double()
        hp = hp.reshape(b, nc, 32, 4)
        acc = torch.zeros(b, four_h, 32, dtype=torch.float32)
        for ci in range(nc):
            for e in range(4):
                prod = hp[:, None, ci, :, e] * w[None, :, ci, :, e]   # exact in f64
                acc = (prod + acc.double()).float()                   # one fused add
        for half in (16, 8, 4, 2, 1):                                 # lane bits 4 .. 0
            acc = acc.reshape(b, four_h, -1, 2, half)
            acc = acc[..., 0, :] + acc[..., 1, :]
        gates = acc.reshape(b, four_h) + gates_x[t]
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o, g = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o), torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), h, c


def test_kernel_sum_order_holds_lstm_tol_over_750_steps():
    rng = np.random.default_rng(20260816)
    t_len, b, h_dim = 750, 4, 512
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    gates_x = t(0.5 * rng.standard_normal((t_len, b, 4 * h_dim)))
    w_hh = t(rng.uniform(-1, 1, (4 * h_dim, h_dim)) * h_dim ** -0.5)
    h0 = t(0.1 * rng.standard_normal((b, h_dim)))
    c0 = t(0.1 * rng.standard_normal((b, h_dim)))
    got = _kernel_order_scan(gates_x, w_hh, h0, c0)
    want = lstm_scan_plain(gates_x, w_hh, h0, c0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **LSTM_TOL)
