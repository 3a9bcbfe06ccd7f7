"""The benchmark's counts of operations and bytes against closed forms at
small shapes, and the dense forward's products against the port's own
count (``roofline/counting.py::count_step``) where both count the same
work."""
from __future__ import annotations

import pytest
import torch

from perfbench import counts
from perfbench.tests.helpers import DATA
from perfbench import common


@pytest.mark.parametrize("S", [1, 7, 64])
def test_attention_pairs_closed_form(S):
    assert counts.attention_pairs(S, S, True, 0) == S * (S + 1) // 2
    assert counts.attention_pairs(S, S, False, 0) == S * S
    w = 4
    assert counts.attention_pairs(S, S, True, w) == sum(min(i + 1, w)
                                                        for i in range(S))


def test_attention_work_closed_form():
    B, S, H, D = 2, 16, 4, 8
    flops, nbytes = counts.attention_work(B, S, S, H, H, D, True, 0, 2)
    assert flops == 4 * B * H * D * S * (S + 1) // 2
    assert nbytes == 4 * B * S * H * D * 2


def test_bound_takes_the_larger_time():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_train_step_is_three_forwards():
    port = common.load_json(DATA / "tiny-dense.json")["port"]
    S = 32
    fwd = counts.forward_flops(port, 2 * S, 2 * counts.attention_pairs(
        S, S, True, 0), 2 * S)
    assert counts.train_step_flops(port, 2, S) == 3 * fwd


def test_dense_prefill_and_decode_closed_form():
    port = common.load_json(DATA / "tiny-dense.json")["port"]
    d, H, D, ff, V, L = 64, 4, 16, 128, 256, 2
    S = 32
    layer = lambda n, pairs: (2 * n * d * D * 4 * H + 4 * H * D * pairs
                              + 6 * n * d * ff)
    assert counts.prefill_flops(port, S) == (
        L * layer(S, S * (S + 1) // 2) + 2 * d * V)
    assert counts.decode_flops(port, S) == L * layer(1, S) + 2 * d * V


def test_dense_forward_agrees_with_the_ports_count():
    """The port's count of a dense loss on the CPU: its products are the
    projections, the MLP, the head over every position and attention over
    every (query, key) pair of the one key chunk (``sdpa_chunked`` scores
    the masked half too), which ``forward_flops`` gives with all S² pairs."""
    from repro_torch.models.model import Model
    from repro_torch.roofline.counting import count_step

    from perfbench import weights
    from perfbench.reference import dense

    port = dict(common.load_json(DATA / "tiny-dense.json")["port"],
                compute_dtype="float32")
    cfg = common.port_config({"port": port})
    model = Model(cfg, device="cpu")
    params = weights.make(dense.layout(port), 3, "cpu")
    B, S = 2, 16
    tok = torch.randint(0, 256, (B, S))
    c = count_step(model.loss, params, {"tokens": tok, "labels": tok})
    assert c.flops == counts.forward_flops(port, B * S, B * S * S, B * S)
