"""The operation and byte counts against hand counts and against the
operations torch counts in the reference's own forward and backward, at
the tiny preset."""

import pytest
from torch.utils.flop_counter import FlopCounterMode

import tiny
import pb_counts as C
import pb_reference as R
import pb_weights

pre_job = tiny.pb_harness.load_job("pretrain")
ft_job = tiny.pb_harness.load_job("finetune")


def test_rules():
    assert C.chunk_sizes(64, 5) == [13, 13, 13, 13, 12]
    assert C.chunk_sizes(4, 5) == [1, 1, 1, 1]
    assert C.len_keep_for(512, 0.75) == 128 and C.len_keep_for(196, 0.75) == 49
    assert C.mlp_route("auto", 768, 3072) == "lnfres"
    assert C.mlp_route("auto", 32, 128) == "dense"
    assert C.attention_route("auto", 768, 12) == "token_major"
    assert C.attention_route("pallas", 1280, 16) == "head_major"
    assert C.attention_route("auto", 1280, 16) == "xla"
    assert C.attention_route("auto", 512, 16) == "token_major"


def test_hand_counts():
    # one block over 2 x 3 tokens at D 4, H 16: qkv 2*6*4*12, proj 2*6*4*4,
    # fc1 and fc2 2*6*4*16 each, attention 4*2*3*3*4
    assert C.block_flops(2, 3, 4, 16) == 576 + 192 + 768 + 768 + 288
    # attention (b 2, N 8, 4 heads of 16), token-major: sq = 2*4*8*8*16
    sq, tok, st = 8192, 2 * 8 * 64 * 2, 2 * 4 * 8 * 8
    fwd, bwd = C.attention_bounds("token_major", 2, 8, 4, 16)
    peak, bw = C.PEAKS["bf16_flops"], C.PEAKS["hbm_bytes_per_s"]
    assert fwd == pytest.approx(max(4 * sq / peak, (4 * tok + st) / bw))
    # backward: do v^T, dv, dq, dk; the kernel's recomputed q k^T not counted
    assert bwd == pytest.approx(max(8 * sq / peak, (8 * tok + st) / bw))
    # K3 over 10 rows, D 128, H 512: 4*10*128*512 operations, bytes
    # 2*(2*10*128 + 2*128*512 + 10*512)
    fwd, bwd = C.mlp_bounds("lnfres", 10, 128, 512)
    assert bwd is None
    assert fwd == pytest.approx(max(4 * 10 * 128 * 512 / peak,
                                    2 * (2560 + 131072 + 5120) / bw))
    fwd, bwd = C.mlp_bounds("fused", 10, 128, 512)
    # backward: dh, dx, dw1, dw2; the kernel's recomputed fc1 not counted
    assert bwd == pytest.approx(max(8 * 10 * 128 * 512 / peak,
                                    (2 * (3840 + 131072)
                                     + 4 * (1024 + 131072 + 128)) / bw))


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_pretrain_flops_against_torch():
    cell = tiny.cell("base-pretrain-b64")
    cfg, B = cell.config, cell.traffic["batch"]
    job = pre_job.Job(cell, 11, device="cpu", program=False)
    P = pb_weights.make(job.spec, 11, "cpu")
    for p in P.values():
        p.requires_grad_(True)
    model = R.Model(cfg, P, remat=False)
    (a, v), (d1, d2) = job.compared[0]

    def step():
        model.contrastive(a, v, d1)[0].backward()
        model.mae(a, v, d2)[0].backward()

    assert _counted(step) == C.pretrain_model_flops(cfg, B)


@pytest.mark.parametrize("branch", ["av", "a", "v"])
def test_finetune_flops_against_torch(branch):
    cell = tiny.cell("base-ft-vggsound-b64")
    cfg, B, classes = cell.config, cell.traffic["batch"], cell.traffic["label_dim"]
    job = ft_job.Job(cell, 12, device="cpu", program=False)
    P = pb_weights.make(job.spec, 12, "cpu")
    for p in P.values():
        p.requires_grad_(True)
    model = R.Model(cfg, P, remat=False)
    a, v, y = job.compared[0][0]
    count = _counted(lambda: R.ce_soft(model.finetune(a, v)[branch],
                                       y).backward())
    assert count == C.finetune_model_flops(cfg, B, classes, branch)


def test_kernel_calls_at_full_widths():
    base = tiny.pb_harness.load_cell("base-pretrain-b64").config
    huge = tiny.pb_harness.load_cell("huge-pretrain-b64").config
    # base: K1/K2 and K3 at every block call of the step, no MLP backward
    calls = C.pretrain_kernel_calls(base, 64)
    fwd_attn = [n for fam, _, _, n in calls if fam == "attention"]
    # 5 chunks x 2 modalities x 12 blocks + 2 x 12 + 2 + 8 block calls,
    # each a forward and a backward call
    assert sum(fwd_attn) == 2 * (5 * 2 * 12 + 2 * 12 + 2 + 8)
    assert sum(n for fam, _, _, n in calls if fam == "mlp") == 5 * 2 * 12 + 2 * 12 + 2 + 8
    assert not [c for c in calls if c[1] == "remat"]
    # huge: trunk blocks under remat run their forward kernels twice, the
    # second time counted apart, as a forward, under 'remat'
    calls = C.pretrain_kernel_calls(huge, 64)
    trunk = 5 * 2 * 32 + 2 * 32
    by_pass = {}
    for fam, p, s, n in calls:
        if fam == "mlp":
            by_pass[p] = by_pass.get(p, 0) + n
    assert by_pass == {"forward": trunk + 2 + 8, "remat": trunk,
                       "backward": trunk + 2 + 8}
    fwd = {(s, n) for fam, p, s, n in calls if p == "forward"}
    assert {(s, n) for fam, p, s, n in calls if p == "remat"} <= fwd
    assert C.pretrain_model_flops(huge, 64) > 5 * C.pretrain_model_flops(base, 64)
