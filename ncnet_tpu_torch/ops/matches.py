"""Correlation readout: dense hard-argmax matches (``ncnet_tpu/ops/matches.py``)."""

import torch


def _lin(scale, n, device):
    if scale == "centered":
        return torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)
    if scale == "positive":
        return torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)
    raise ValueError(f"unknown scale {scale!r}")


def corr_to_matches(
    corr,
    delta4d=None,
    k_size=1,
    do_softmax=False,
    scale="centered",
    invert_matching_direction=False,
    return_indices=False,
):
    """Hard-argmax match readout from ``corr [b, iA, jA, iB, jB]``.

    The default direction finds, for every B cell, the best A cell (softmax
    over the A cells); ``invert_matching_direction`` finds, for every A
    cell, the best B cell. Ties take the first maximum. Returns
    ``(xA, yA, xB, yB, score)``, each ``[b, N]``, plus the grid indices
    ``(iA, jA, iB, jB)`` with ``return_indices``.
    """
    if delta4d is not None:
        raise NotImplementedError(
            "relocalization offsets (delta4d) need maxpool4d, which is not "
            "ported yet (ROADMAP A2)"
        )
    b, fs1, fs2, fs3, fs4 = corr.shape
    flat = corr.reshape(b, fs1 * fs2, fs3 * fs4)
    dev = corr.device
    if invert_matching_direction:
        if do_softmax:
            flat = torch.softmax(flat, dim=2)
        score = torch.amax(flat, dim=2)
        idx = torch.argmax(flat, dim=2)
        i_b, j_b = idx // fs4, idx % fs4
        n = fs1 * fs2
        ar = torch.arange(n, device=dev)
        i_a = (ar // fs2).expand(b, n)
        j_a = (ar % fs2).expand(b, n)
    else:
        if do_softmax:
            flat = torch.softmax(flat, dim=1)
        score = torch.amax(flat, dim=1)
        idx = torch.argmax(flat, dim=1)
        i_a, j_a = idx // fs2, idx % fs2
        n = fs3 * fs4
        ar = torch.arange(n, device=dev)
        i_b = (ar // fs4).expand(b, n)
        j_b = (ar % fs4).expand(b, n)

    if k_size != 1:
        i_a, j_a = i_a * k_size, j_a * k_size
        i_b, j_b = i_b * k_size, j_b * k_size

    x_a = _lin(scale, fs2 * k_size, dev)[j_a]
    y_a = _lin(scale, fs1 * k_size, dev)[i_a]
    x_b = _lin(scale, fs4 * k_size, dev)[j_b]
    y_b = _lin(scale, fs3 * k_size, dev)[i_b]

    if return_indices:
        return x_a, y_a, x_b, y_b, score, i_a, j_a, i_b, j_b
    return x_a, y_a, x_b, y_b, score
