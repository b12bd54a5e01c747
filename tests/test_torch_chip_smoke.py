"""chip_smoke.py's start on a host whose CUDA does not come up: with no card
it gives up at once (exit 2, no result printed); with a card it tries again
in fresh processes for a while and, once CUDA is up, runs itself again."""
from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.delenv(mod.CUDA_WAITED, raising=False)
    monkeypatch.setattr(mod, "CUDA_RETRY_S", 0)
    return mod


def _probes(monkeypatch, smoke, outcomes):
    """Replace the fresh-process probe with ``outcomes`` in turn (rc,
    stdout, stderr), the last one repeated; returns the calls made."""
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        rc, out, err = outcomes[min(len(calls), len(outcomes)) - 1]
        return subprocess.CompletedProcess(cmd, rc, out, err)

    monkeypatch.setattr(smoke.subprocess, "run", run)
    return calls


def test_no_card_gives_up_without_a_probe(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "card_present", lambda: False)
    calls = _probes(monkeypatch, smoke, [(0, "1\n", "")])
    assert smoke.wait_for_cuda() is False
    assert calls == []


def test_a_rerun_does_not_wait_again(smoke, monkeypatch):
    monkeypatch.setattr(smoke, "card_present", lambda: True)
    monkeypatch.setenv(smoke.CUDA_WAITED, "1")
    calls = _probes(monkeypatch, smoke, [(0, "1\n", "")])
    assert smoke.wait_for_cuda() is False
    assert calls == []


@pytest.mark.parametrize("fails", [0, 1, 3])
def test_a_card_is_tried_until_cuda_is_up(smoke, monkeypatch, capsys, fails):
    monkeypatch.setattr(smoke, "card_present", lambda: True)
    monkeypatch.setattr(smoke, "CUDA_WAIT_S", 60)
    err = "RuntimeError: CUDA driver initialization failed"
    calls = _probes(monkeypatch, smoke, [(1, "", f"warning\n{err}\n")] * fails + [(0, "1\n", "")])
    assert smoke.wait_for_cuda() is True
    assert len(calls) == fails + 1
    assert all(c[0] == sys.executable and "torch.cuda.init()" in c[-1] for c in calls)
    assert capsys.readouterr().err.count(err) == fails


@pytest.mark.parametrize("outcome", [(1, "", "RuntimeError: no CUDA\n"), (0, "0\n", "")],
                         ids=["probe fails", "probe counts no card"])
def test_a_card_whose_cuda_stays_down_gives_up_at_the_deadline(smoke, monkeypatch, outcome):
    monkeypatch.setattr(smoke, "card_present", lambda: True)
    monkeypatch.setattr(smoke, "CUDA_WAIT_S", 0.2)
    calls = _probes(monkeypatch, smoke, [outcome])
    assert smoke.wait_for_cuda() is False
    assert len(calls) >= 1


def test_main_without_cuda_exits_2_and_prints_no_result(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(smoke, "card_present", lambda: False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert smoke.main() == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "is_available() is False" in out.err


@pytest.mark.parametrize("args", [[], ["--parent", "."]], ids=["no arguments", "--parent"])
def test_main_runs_again_once_cuda_is_up(smoke, monkeypatch, args):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(smoke, "wait_for_cuda", lambda: True)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", *args])
    monkeypatch.chdir(ROOT)

    class Exec(Exception):
        pass

    def execv(path, argv):
        raise Exec(path, argv)

    monkeypatch.setattr(smoke.os, "execv", execv)
    with pytest.raises(Exec) as ran:
        smoke.main()
    path, argv = ran.value.args
    assert path == sys.executable
    assert argv == [sys.executable, str(ROOT / "chip_smoke.py"), *args]
    assert smoke.os.environ[smoke.CUDA_WAITED] == "1"


class _Ev:
    """A stand-in for one of Kineto's raw events."""

    def __init__(self, name, device, corr, start, us=1.0):
        self._n, self._d, self._c, self._s, self._us = name, device, corr, start, us

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return int(self._us * 1e3)


def _prof(events):
    res = type("R", (), {"events": lambda self: events})()
    return type("P", (), {"profiler": type("K", (), {"kineto_results": res})()})()


def _launches(first_corr, n, start, kernel="k", lost=(), us=1.0):
    """``n`` eager launches with their device records but those in ``lost``."""
    out = []
    for i in range(n):
        c = first_corr + i
        out.append(_Ev("cudaLaunchKernel", False, c, start + i))
        if i not in lost:
            out.append(_Ev(kernel, True, c, start + i + 1, us))
    return out


@pytest.mark.parametrize("lost_in_head", [(), (0, 1, 2)])
def test_trace_leaves_out_its_head(smoke, lost_in_head):
    """The head's launches and records count nowhere, and records the head
    lost are not the body's loss."""
    ev = (_launches(1, 4, 0, "add", lost=lost_in_head, us=0.5)
          + _launches(100, 3, 100, "body", us=2.0) + [_Ev("cudaStreamSynchronize", False, 200, 300)])
    t = smoke.Trace(_prof(ev), head=4, wall=0.01)
    assert t.lost == 0
    assert t.device == [("body", 2.0)] * 3
    assert t.busy_us() == 6.0 and t.by_op() == {"body": 6.0}
    assert t.count(smoke.LAUNCH_OPS) == 3 and t.count(smoke.SYNC_OPS) == 1


def test_trace_counts_the_body_launches_without_records(smoke):
    ev = _launches(1, 2, 0, "add") + _launches(100, 5, 100, "body", lost=(0, 1))
    t = smoke.Trace(_prof(ev), head=2, wall=0.01)
    assert t.lost == 2 and len(t.device) == 3


def test_trace_holds_graph_replays_to_each_other(smoke):
    """A replay of the same graph that kept fewer of its kernels' records
    than another counts the difference as lost."""
    ev = _launches(1, 1, 0, "add")
    for r, kept in enumerate((3, 3, 1)):
        c = 50 + r
        ev.append(_Ev("cudaGraphLaunch", False, c, 10 + 10 * r))
        ev += [_Ev(f"g{j}", True, c, 11 + 10 * r + j) for j in range(kept)]
    t = smoke.Trace(_prof(ev), head=1, wall=0.01)
    assert t.lost == 2 and len(t.device) == 7
    assert t.top(1) == [("g0", 3e-3)]


def test_trace_sums_ops_that_share_a_name_prefix(smoke):
    long = "void k<" + "x" * 100
    ev = _launches(1, 2, 0, long + "A>", us=1.0) + _launches(10, 1, 10, long + "B>", us=2.0)
    t = smoke.Trace(_prof(ev), head=0, wall=0.01)
    assert t.by_op() == {long[:80]: 4.0}


# ---------------------------------------------------------------------------
# phase 6c (the moe and vlm families): what can be checked without a card
# ---------------------------------------------------------------------------

PHASES = ("kernel_phase", "slice_phase", "batch_phase", "lasso_phase", "profile_phase",
          "adapt_phase", "prefill_phase", "mesh_phase", "spec_phase", "family_phase",
          "state_phase", "encdec_phase", "train_phase")


def test_main_runs_the_family_phase_after_spec_and_before_train(smoke, monkeypatch):
    """With every phase stubbed, main() calls them in order: phase 6f
    (``mesh_phase``) right after 6, on phase 3's model, then 6b, 6c
    (``family_phase``), 6d (``state_phase``), 6e (``encdec_phase``), and 7
    last."""
    from repro_torch.kernels import _build

    calls = []

    class Stop(Exception):
        pass

    def stub(name):
        def run(results, *a):
            calls.append(name)
            if name == "train_phase":
                raise Stop
            return (None, None, {"head": {"experts": None}}, [(None, None)]) \
                if name == "slice_phase" else None
        return run

    for name in PHASES:
        monkeypatch.setattr(smoke, name, stub(name))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(smoke, "card_line", lambda: "a card, 700 W")
    monkeypatch.setattr(smoke, "stand_in_mask", lambda cfg, dev: None)
    monkeypatch.setattr(smoke, "wgmma_registers", lambda log: {})
    monkeypatch.setattr(_build, "build_all", lambda: {})
    monkeypatch.setattr(_build, "build_log", lambda name: "")
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    with pytest.raises(Stop):
        smoke.main()
    assert calls == list(PHASES)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b", "internvl2-26b"])
def test_new_heads_are_in_the_verify_and_wide_head_cases(smoke, arch):
    """Each new config's head is in phase 2's verify-head cases with its K, d,
    the verify step's capacity (B 40 at the config's capacity factor) and
    the V_pad of its stand-in mask, and in phase 6b (c)'s head cases."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    rows = {name: rest for name, *rest in smoke.VERIFY_HEADS}
    K, C, d, v_pad = rows[arch]
    mask = smoke.stand_in_mask(cfg, "cpu")
    assert (K, d) == (cfg.ds.num_experts, cfg.d_model)
    assert C == max(1, round(smoke.N_SLOTS * (smoke.FAMILY_GAMMA + 1) / K
                             * cfg.ds.capacity_factor))
    assert v_pad == -(-int(mask.sum(1).max()) // 128) * 128
    assert arch in smoke.WIDE_HEAD_ARCHS


def test_family_phase_sizes(smoke):
    """The expert-bytes bound of an olmoe-1b-7b decode step (every expert
    read once: 12.88 GB, 3.85 ms at 3.35 TB/s); every session's
    max_seq_len holds its longest prompt, its new tokens and a verify
    block, and divides into pages and chunks; the models' weights fit the
    card one at a time."""
    from repro_torch.configs import get_config

    olmoe = get_config("olmoe-1b-7b")
    nbytes = smoke.moe_expert_bytes(olmoe)
    assert nbytes == 16 * 3 * 64 * 2048 * 1024 * 2
    assert 1e3 * nbytes / smoke.HBM_BYTES_PER_S == pytest.approx(3.846, abs=1e-3)
    assert smoke.FAMILY_SEQ >= max(smoke.FAMILY_PROMPT_LENS) + smoke.FAMILY_NEW - 1 \
        + smoke.FAMILY_GAMMA
    assert smoke.FAMILY_SEQ % smoke.PAGE_SIZE == 0 and smoke.FAMILY_SEQ % smoke.FAMILY_CHUNK == 0
    assert len(smoke.FAMILY_PROMPT_LENS) == smoke.N_SLOTS
    assert smoke.FAMILY_PROMPT_LENS[smoke.FAMILY_SOLO] == max(smoke.FAMILY_PROMPT_LENS)
    assert smoke.QWEN3_SEQ >= max(smoke.QWEN3_PROMPT_LENS) + smoke.QWEN3_NEW - 1
    assert smoke.INTERNVL_SEQ >= max(smoke.INTERNVL_PROMPT_LENS) + smoke.INTERNVL_NEW - 1
    assert smoke.QWEN3_SEQ % 16 == 0 and smoke.INTERNVL_SEQ % 16 == 0

    def weight_gb(arch, n_layers):
        cfg = get_config(arch).replace(n_layers=n_layers)
        d, L, H, KV, dh = cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        attn = d * H * dh * 2 + 2 * d * KV * dh
        ffn = (3 * cfg.moe.num_experts * d * cfg.moe.d_ff_expert + d * cfg.moe.num_experts
               if cfg.moe is not None else 3 * d * cfg.d_ff)
        head = cfg.ds.num_experts * cfg.padded_vocab * d
        return 2 * (L * (attn + ffn) + cfg.padded_vocab * d + head) / 1e9

    assert weight_gb("olmoe-1b-7b", 16) == pytest.approx(15.0, abs=0.5)
    for arch, layers in (("olmoe-1b-7b", 16), ("qwen3-moe-235b-a22b", smoke.QWEN3_LAYERS),
                         ("internvl2-26b", smoke.INTERNVL_LAYERS)):
        assert weight_gb(arch, layers) < 60, arch


def test_finite_stats_finds_a_nan_anywhere(smoke):
    smoke._finite_stats("ok", {"a": 1.0, "b": [2, {"c": 0.5}], "d": None, "e": "x"})
    for bad in ({"a": float("nan")}, {"b": [1.0, {"c": float("inf")}]}):
        with pytest.raises(smoke.SmokeFailure, match="stats"):
            smoke._finite_stats("bad", bad)


# ---------------------------------------------------------------------------
# phase 6d (the ssm and hybrid families): what can be checked without a card
# ---------------------------------------------------------------------------

def test_state_phase_sizes(smoke):
    """Every 6d session's max_seq_len holds its longest prompt, its new
    tokens and a verify block, and divides into pages and chunks; the
    shared system prompt is whole chunks; mamba2-130m runs at full depth and
    zamba2-7b with all 81 layers (13 shared-block applications and a
    remainder of 3)."""
    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import _layout

    assert smoke.STATE_SEQ >= max(smoke.STATE_PROMPT_LENS) + smoke.STATE_NEW - 1 \
        + smoke.STATE_GAMMA
    assert smoke.STATE_SEQ >= smoke.STATE_SYSTEM + max(smoke.STATE_TAILS) + smoke.STATE_NEW - 1
    assert smoke.STATE_SEQ >= max(smoke.PREEMPT_LENS) + smoke.STATE_NEW - 1
    for seq in (smoke.STATE_SEQ, smoke.ZAMBA_SEQ):
        assert seq % smoke.PAGE_SIZE == 0 and seq % smoke.STATE_CHUNK == 0
    assert smoke.ZAMBA_SEQ >= max(smoke.ZAMBA_PROMPT_LENS) + smoke.ZAMBA_NEW - 1
    assert smoke.STATE_SYSTEM % smoke.STATE_CHUNK == 0 and smoke.STATE_SYSTEM > 0
    assert len(smoke.STATE_PROMPT_LENS) == smoke.N_SLOTS
    assert len(smoke.ZAMBA_PROMPT_LENS) == 4 and len(smoke.STATE_TAILS) == 4
    assert get_config("mamba2-130m").n_layers == 24
    assert _layout(get_config("zamba2-7b")) == (13, 3)
    assert smoke.ZAMBA_PREFILL == 2048


def _weight_bytes(cfg):
    """The backbone's layer and final-norm bytes and the shared block's,
    from the full-width leaf shapes (fp32 norms, A_log, dt_bias and D; the
    rest in the config dtype)."""
    from repro_torch.convert import _expected_shapes

    fp32 = ("scale", "A_log", "dt_bias", "D", "norm_scale")
    layers = shared = 0
    for path, shape in _expected_shapes(cfg).items():
        n = int(np.prod(shape)) * (4 if path.rsplit("/", 1)[-1] in fp32 else 2)
        if path.startswith(("layers/", "final_norm/")):
            layers += n
        elif path.startswith("shared_attn/"):
            shared += n
    return layers, shared


def test_state_decode_bytes_from_the_specs(smoke):
    """The bytes bounds of 6d's decode steps. mamba2-130m: a slot's ssm
    state is 24 x 786,432 B (fp32 (24, 64, 128) a layer), read and written
    each step: 37.7 MB a slot, 302 MB at 8 slots, more than the backbone's
    bf16 weights. zamba2-7b: 81 x 1,835,008 B of ssm state a slot (297 MB
    read and written), 12.6 GB of layer weights and the shared block's
    0.41 GB read 13 times (5.3 GB)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import paged_cache_specs

    mamba = get_config("mamba2-130m")
    ssm, conv = smoke.state_bytes(mamba)
    assert ssm == 24 * 786_432 and conv == 24 * 3 * 1792 * 2
    w, shared = _weight_bytes(mamba)
    assert shared == 0 and 0.17e9 < w < 0.19e9
    pos = [n + smoke.STATE_NEW for n in smoke.STATE_PROMPT_LENS]
    b = smoke.state_decode_bytes(mamba, w, shared, 768 * 2, pos)
    assert b["state_read_write"] == 2 * 8 * (ssm + conv)
    assert 2 * 8 * ssm == pytest.approx(302e6, rel=1e-3) and 2 * 8 * ssm > w
    assert b["kv_read"] == 0 and b["shared_block"] == 0
    assert b["total"] == w + 8 * 768 * 2 + b["state_read_write"]

    zamba = get_config("zamba2-7b")
    ssm, conv = smoke.state_bytes(zamba)
    assert ssm == 81 * 1_835_008 and conv == 81 * 3 * 7296 * 2
    assert 2 * ssm == pytest.approx(297.3e6, rel=1e-3)
    w, shared = _weight_bytes(zamba)
    assert w == pytest.approx(12.63e9, rel=2e-3) and shared == pytest.approx(411e6, rel=2e-3)
    pos = [n + smoke.ZAMBA_NEW for n in smoke.ZAMBA_PROMPT_LENS] + [0] * 4
    b = smoke.state_decode_bytes(zamba, w, shared, 3584 * 2, pos)
    assert b["shared_block"] == 13 * shared == pytest.approx(5.34e9, rel=2e-3)
    assert b["kv_read"] == 13 * sum(p + 1 for p in pos) * 2 * 32 * 112 * 2
    assert b["total"] == sum(v for k, v in b.items() if k != "total")
    # the paged state arena at 8 slots: 4 x 8 pages (and 2 reserved) of a
    # slot's 148.6 MB of ssm state
    arena = paged_cache_specs(zamba, 2, smoke.PAGE_SIZE, 2 + 4 * smoke.N_SLOTS).ssm
    assert arena.shape == (81, 34, 112, 64, 64)
    assert int(np.prod(arena.shape)) * 4 == 34 * ssm


# ---------------------------------------------------------------------------
# phase 6e (the encdec family): what can be checked without a card
# ---------------------------------------------------------------------------

def test_encdec_phase_sizes(smoke):
    """6e serves whisper-base (6 + 6 layers, no cut) and paper-envi at full
    width: 8 requests of 1500 frames (``input_specs``: whisper's stub, and
    the default for paper-envi, which has none) and a 64-token target
    prefix, then 64 greedy steps, on a self cache of 448 positions
    (whisper's decoder context) that holds them; every path of the sessions'
    head list, ``jnp`` the reference."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models.model_zoo import input_specs

    assert smoke.ENCDEC_ARCHS == ("whisper-base", "paper-envi")
    assert smoke.ENCDEC_SEQ == 448 >= smoke.ENCDEC_PREFIX + smoke.ENCDEC_NEW
    assert (smoke.ENCDEC_PREFIX, smoke.ENCDEC_NEW) == (64, 64)
    assert set(smoke.ENCDEC_KERNELS) == {"auto", "cuda_fused", "cuda_grouped", "jnp"}
    assert smoke.ENCDEC_KERNELS[-1] == "jnp"
    for arch, layers in (("whisper-base", (6, 6)), ("paper-envi", (2, 2))):
        cfg = get_config(arch)
        assert (cfg.n_encoder_layers, cfg.n_layers) == layers
        spec = input_specs(cfg, ShapeConfig("e", smoke.ENCDEC_PREFIX, smoke.N_SLOTS, "prefill"))
        assert spec["frames"].shape == (smoke.N_SLOTS, 1500, cfg.d_model)
        assert spec["tokens"].shape == (smoke.N_SLOTS, smoke.ENCDEC_PREFIX)


def test_encdec_decode_bytes_from_the_shapes(smoke):
    """The bytes bound of a whisper-base decode step at 8 slots, position
    128: the decoder's bf16 weights (6 layers of two 512 x 512 attention
    blocks of four matrices and a 512 x 2048 gelu MLP: 50.33 MB, plus fp32
    norms), the bf16 cross K/V of 1500 frames (147.5 MB, the largest part),
    the self K/V up to each slot's position (12.7 MB), the token and
    position rows, and the gate with u experts' V_pad rows."""
    from repro_torch.configs import get_config
    from repro_torch.convert import _expected_shapes

    cfg = get_config("whisper-base")
    dec = sum(int(np.prod(s)) * (4 if p.endswith(("scale", "bias")) else 2)
              for p, s in _expected_shapes(cfg).items()
              if p.startswith(("dec_layers/", "dec_norm/")))
    assert dec == 6 * (8 * 512 * 512 + 2 * 512 * 2048) * 2 + 6 * 3 * 2 * 512 * 4 + 2 * 512 * 4
    pos = [128] * 8
    b = smoke.encdec_decode_bytes(cfg, dec, pos, 1500, 5, 8192)
    assert b["cross_kv"] == 6 * 8 * 1500 * 2 * 512 * 2 == 147_456_000
    assert b["self_kv"] == 6 * 8 * 129 * 2 * 512 * 2
    assert b["embedding_rows"] == 2 * 8 * 512 * 2
    assert b["head"] == (8 + 5 * 8192) * 512 * 2
    assert b["total"] == sum(v for k, v in b.items() if k != "total")
    assert 1e3 * b["total"] / smoke.HBM_BYTES_PER_S == pytest.approx(0.0754, abs=1e-4)


# ---------------------------------------------------------------------------
# phase 6f (serving on a mesh): what can be checked without a card
# ---------------------------------------------------------------------------

def test_mesh_phase_sizes(smoke):
    """6f runs the sharded head at decode, a verify step and a whole
    prompt; the local halves at ep 2 and 4, which divide qwen2-1.5b's 16
    experts (no padding: the shards' counts concatenate to serve_topk's);
    the 1x1 sessions through the fused kernel and ``auto``."""
    from repro_torch.configs import get_config

    assert smoke.MESH_BATCHES == (1, 8, 40, 2048)
    assert smoke.MESH_LOCAL_BATCHES == (8, 2048)
    K = get_config("qwen2-1.5b").ds.num_experts
    assert all(K % ep == 0 for ep in smoke.MESH_EPS) and smoke.MESH_EPS == (2, 4)
    assert set(smoke.MESH_SESSION_KERNELS) <= set(smoke.SESSION_KERNELS)


@pytest.mark.parametrize("path,delta,ok", [
    ("cuda_fused", {"dss_topk_fused_q": 1}, True),
    ("cuda_fused", {"dss_topk_grouped": 1}, False),
    ("cuda_grouped", {"dss_topk_grouped_wgmma": 2}, True),
    ("cuda_pertoken", {"dss_topk": 1}, True),
    ("auto", {"dss_topk_grouped_tiled": 1}, True),
    ("auto", {}, False),
    ("jnp", {}, True),
    ("jnp", {"dss_topk_fused": 1}, False),
    ("jnp", {"flash_attention_wgmma": 3}, True),
])
def test_mesh_phase_requires_each_paths_bodies(smoke, path, delta, ok):
    from repro_torch.kernels import ops

    counts = {name: delta.get(name, 0) for name, _, _ in ops.BODIES}
    if ok:
        smoke._mesh_bodies_launched("t", path, counts)
    else:
        with pytest.raises(smoke.SmokeFailure):
            smoke._mesh_bodies_launched("t", path, counts)
