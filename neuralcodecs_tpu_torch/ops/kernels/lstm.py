"""LSTM layer recurrence: the CUDA kernel csrc/lstm.cu and its plain version.

Replaces neuralcodecs_tpu/ops/pallas/lstm.py:lstm_scan_pallas. One LSTM
layer over a precomputed input projection, gate order i, f, g, o, with
(h, c) carried. On the H100 the recurrence is bound by the serial latency
of a step, not by bytes or flops: the plain loop pays about nine launches
per step, the kernel one handoff between its blocks through a counter in
device memory (see the header of csrc/lstm.cu). A launch zeroes the
counter on its stream first, so it keeps no state on the host and can be
captured into a CUDA graph (ops/graphs.py) and replayed after other
launches; launches on one device must still not overlap. The kernel takes H up to
128 x 5 and up to 4 units a block on each SM (H <= 528 on an H100); larger
H raises at the launch.

``w_hh`` is taken in torch's layout [4H, H] (``nn.LSTM.weight_hh_l*``, and
what ``core.weights.from_jax_params`` makes of the JAX package's [H, 4H]),
so neither version converts it per call.

``lstm_scan`` is the wrapper: the plain version for CPU tensors, the kernel
for CUDA tensors, or an error. ``lstm_scan.launches`` counts kernel launches.
The kernel has no backward: on CUDA tensors that require grad, in grad
mode, the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from neuralcodecs_tpu_torch.ops.kernels.build import (check, device_and_stream, load_library,
                                                      refuse_grad)


def lstm_scan_plain(gates_x: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """gates_x [T, B, 4H], w_hh [4H, H], h0/c0 [B, H] f32 ->
    (ys [T, B, H], h_f [B, H], c_f [B, H]); the step of the JAX scan
    (neuralcodecs_tpu/models/encodec/seanet.py, _lstm_recurrence)."""
    t_len, b, _ = gates_x.shape
    h, c = h0, c0
    w_t = w_hh.t()
    ys = gates_x.new_empty(t_len, b, w_hh.shape[1])
    for t in range(t_len):
        gates = torch.addmm(gates_x[t], h, w_t)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return ys, h, c


def _check_inputs(tensors: dict[str, torch.Tensor]) -> None:
    gates_x = tensors["gates_x"]
    if gates_x.dim() != 3 or gates_x.shape[2] % 4:
        raise ValueError(f"lstm_scan: gates_x must be [T, B, 4H], got {tuple(gates_x.shape)}")
    t_len, b, four_h = gates_x.shape
    h = four_h // 4
    if t_len == 0 or b == 0 or h == 0:
        raise ValueError(f"lstm_scan: empty gates_x {tuple(gates_x.shape)}")
    shapes = {"gates_x": (t_len, b, four_h), "w_hh": (four_h, h), "h0": (b, h), "c0": (b, h)}
    for name, t in tensors.items():
        if t.device != gates_x.device or t.device.type != "cuda":
            raise ValueError(f"lstm_scan: {name} on {t.device}, want {gates_x.device} (cuda)")
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_scan: {name} is {t.dtype}, want float32")
        if not t.is_contiguous():
            raise ValueError(f"lstm_scan: {name} is not contiguous")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"lstm_scan: {name} shape {tuple(t.shape)}, want {shapes[name]}")


def lstm_scan(gates_x: torch.Tensor, w_hh: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ys [T, B, H], h_f, c_f [B, H]) for gates_x [T, B, 4H], w_hh [4H, H],
    h0/c0 [B, H], all f32."""
    tensors = {"gates_x": gates_x, "w_hh": w_hh, "h0": h0, "c0": c0}
    if all(t.device.type == "cpu" for t in tensors.values()):
        return lstm_scan_plain(gates_x, w_hh, h0, c0)
    _check_inputs(tensors)
    refuse_grad("lstm_scan", *tensors.values())
    lib = load_library()
    t_len, b, four_h = gates_x.shape
    h = four_h // 4
    ys = torch.empty(t_len, b, h, dtype=torch.float32, device=gates_x.device)
    h_f, c_f = torch.empty_like(h0), torch.empty_like(c0)
    rc = lib.nc_lstm_scan_f32(gates_x.data_ptr(), w_hh.data_ptr(), h0.data_ptr(),
                              c0.data_ptr(), ys.data_ptr(), h_f.data_ptr(), c_f.data_ptr(),
                              t_len, b, h, *device_and_stream(gates_x))
    check(rc, "nc_lstm_scan_f32")
    lstm_scan.launches += 1
    return ys, h_f, c_f


lstm_scan.launches = 0


def lstm_scan_plan(b: int, h: int, device: torch.device | str = "cuda") -> tuple[int, int, int]:
    """(U, blocks, BS) of the kernel's launch at batch b, hidden size h on a
    CUDA device: hidden units per block, blocks of the persistent grid, and
    batch rows of h staged per pass (b > BS takes several passes a step).
    Launches nothing."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = (ctypes.c_int * 3)()
    check(load_library().nc_lstm_plan(b, h, index, out), "nc_lstm_plan")
    return out[0], out[1], out[2]
