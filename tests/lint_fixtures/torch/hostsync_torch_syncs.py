# ktpu: hot-path
"""Seeded hostsync violations for the port's lint: the PyTorch sync forms
in a hot module, one of them waived."""

import torch

from kubernetriks_tpu_torch.sanitize import to_host


def window_loop(state, event):
    n = state.time.max().item()  # BAD: .item()
    host = state.pods.phase.cpu()  # BAD: .cpu()
    live = int((state.pods.phase == 1).sum())  # BAD: int() of a tensor
    if state.requeue_signal.any():  # BAD: branch on a tensor
        n += 1
    torch.cuda.synchronize()  # BAD
    event.synchronize()  # BAD: an Event's wait
    rows = to_host(state.time)  # BAD: unwaived to_host
    cursor = state.event_cursor.tolist()  # BAD: .tolist() of a tensor
    copied = state.time.to("cpu")  # BAD: a device-to-host copy
    span = to_host(state.time)  # ktpu: sync-ok(the span's one documented read)
    host_list = [1, 2, 3]
    return n, host, live, rows, cursor, copied, span, len(host_list)
