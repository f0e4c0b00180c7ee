"""The port's tracer (``customnerf_torch/engine/spans.py``) on the CPU: the
nesting and self times of device spans, their order, the host spans under a
profiler, the counters of a training run, the stages of a reconstruction
and an editing step, the ``cn spans`` track of a ``--profile`` trace, and a
run that takes the same steps with the tracer on as off.  The card's
stamps (graph replays, a full ring, re-capture) are held in
``tests/test_torch_kernels_cuda.py``."""

import json
import math

import pytest
import torch

from customnerf_torch.engine import spans
from test_torch_isolation import TINY, build_tiny_guidance, tiny_stack

RECON_STAGES = {"recon.step", "render", "march", "eval", "composite", "loss", "backward",
                "k1.bwd", "adam"}
EDIT_STAGES = {"edit.step", "render", "march", "eval", "composite", "resize", "vae_encode",
               "unet", "loss", "backward", "vae_encode.bwd", "resize.bwd", "render.bwd",
               "k1.bwd", "adam"}


@pytest.fixture
def tracer():
    spans.enable(True, "cpu")
    spans.reset()
    yield spans
    spans.enable(False)
    spans.reset()


def _tags(*names):
    return {n: spans._id(n) for n in names}


@pytest.mark.parametrize("stamps,expect", [
    # a(0, 100) › b(10, 40) › c(20, 30); a › d(50, 90): self a = 100 − 30 − 40
    ([("a", 0, 0), ("b", 0, 10), ("c", 0, 20), ("c", 1, 30), ("b", 1, 40), ("d", 0, 50),
      ("d", 1, 90), ("a", 1, 100)],
     {"a": (100, 30, 0), "b": (30, 20, 1), "c": (10, 10, 2), "d": (40, 40, 1)}),
    # a begin whose end was dropped leaves its parent's time to the parent
    ([("a", 0, 0), ("b", 0, 10), ("a", 1, 100)], {"a": (100, 100, 0)}),
    # two siblings at the top
    ([("a", 0, 0), ("a", 1, 5), ("b", 0, 7), ("b", 1, 9)],
     {"a": (5, 5, 0), "b": (2, 2, 0)}),
])
def test_nesting_and_self_time(stamps, expect):
    """A span's self time is its duration less its children's, so a
    parent's children and its self time add up to it."""
    ids = _tags(*{n for n, _, _ in stamps})
    seq = [(2 * ids[n] + e, t) for n, e, t in stamps]
    got = {}
    for i, k0, k1, depth, self_ns in spans.occurrences(seq):
        got[spans._names[i]] = (seq[k1][1] - seq[k0][1], self_ns, depth)
    assert got == expect
    children = {}
    for n, (dur, _, depth) in got.items():
        if depth == 1:
            children.setdefault("a", []).append(dur)
    if "a" in children:
        assert got["a"][1] + sum(children["a"]) == got["a"][0]


def test_stamps_in_order_and_an_end_closes_what_it_holds(tracer):
    """Stamps are kept in the order they are taken; ending a span ends the
    spans still open inside it first (the backward's hook-opened spans)."""
    with spans.device("outer"):
        spans.begin("inner")
        spans.begin("innermost")
    ids = _tags("outer", "inner", "innermost")
    tags = [tag for tag, _ in spans._cpu_stamps]
    assert tags == [2 * ids["outer"], 2 * ids["inner"], 2 * ids["innermost"],
                    2 * ids["innermost"] + 1, 2 * ids["inner"] + 1, 2 * ids["outer"] + 1]
    times = [t for _, t in spans._cpu_stamps]
    assert times == sorted(times)
    got = spans.collect()["spans"]
    total = got["outer"]["device_ms"]
    assert got["outer"]["self_ms"] + got["inner"]["device_ms"] == pytest.approx(total)
    spans.end("never_opened")                     # nothing to close: no stamp
    assert len(spans._cpu_stamps) == 6


def test_tracer_off_records_nothing_and_makes_no_record_function(monkeypatch):
    """Off and without a profiler, a span is the shared null context: no
    stamp, no host total, no ``record_function``."""
    spans.enable(False)
    spans.reset()
    made = []
    monkeypatch.setattr(spans._profiler, "record_function",
                        lambda name: made.append(name))
    assert spans.device("x") is spans._NULL and spans.span("y") is spans._NULL
    with spans.device("x"), spans.span("y"):
        spans.begin("z")
        spans.end("z")
    x = torch.ones(3, requires_grad=True)
    (spans.at_grad(x * 2, begins="g") ** 2).sum().backward()
    assert not spans._cpu_stamps and not spans._host and not made
    assert spans.collect()["spans"] == {}


def test_host_spans_appear_under_a_profiler_with_the_tracer_off():
    """Under ``torch.profiler`` each host span is a ``cn.<name>`` range,
    tracer on or off; with it off nothing is summed."""
    from torch.profiler import ProfilerActivity, profile
    spans.enable(False)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("epoch"):
            with spans.span("pre_pass"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"cn.epoch", "cn.pre_pass"} <= names
    assert not spans._host


def test_host_totals_with_the_tracer_on_and_counters_always(tracer):
    """With the tracer on, host spans sum their durations by name, no
    profiler needed; a counted span counts whether the tracer is on or not."""
    before = dict(spans.counters)
    for _ in range(3):
        with spans.span("replay"):
            pass
    with spans.span("capture", counter="capture"):
        pass
    spans.enable(False)
    with spans.span("capture", counter="capture"):
        pass
    spans.enable(True, "cpu")
    got = spans.collect()
    assert got["spans"]["replay"]["host_count"] == 3
    assert got["spans"]["capture"]["host_count"] == 1       # summed only while on
    assert got["counters"]["capture"] - before["capture"] == 2
    assert got["counters"]["capture_s"] >= before["capture_s"]


def test_a_full_ring_drops_and_does_not_wrap(tracer, monkeypatch):
    """Past the ring's capacity a stamp is dropped and counted; the stamps
    taken stay as they were."""
    monkeypatch.setattr(spans, "CAPACITY", 5)
    for _ in range(4):
        spans.begin("s")
        spans.end("s")
    assert len(spans._cpu_stamps) == 5 and spans._cpu_stamps[0][0] == 2 * spans._id("s")
    got = spans.collect()
    assert got["counters"]["dropped_stamps"] == 3
    assert got["spans"]["s"]["count"] == 2


def test_at_grad_splits_a_backward(tracer):
    """Hooks stamp where each gradient is complete: a chain x → h1 → h2 → y
    gives, inside ``backward``, ``y.bwd`` then ``h.bwd``, in that order."""
    x = torch.randn(64, requires_grad=True)
    h1 = x.exp()
    h2 = h1.sin()
    y = h2 * 3
    spans.at_grad(y, begins="y.bwd")
    spans.at_grad(h2, ends="y.bwd", begins="h.bwd")
    spans.at_grad(h1, ends="h.bwd")
    with spans.device("backward"):
        y.sum().backward()
    names = [(spans._names[tag >> 1], tag & 1) for tag, _ in spans._cpu_stamps]
    assert names == [("backward", 0), ("y.bwd", 0), ("y.bwd", 1), ("h.bwd", 0),
                     ("h.bwd", 1), ("backward", 1)]


def _tiny_trainer(tmp_path, extra=(), **kw):
    from customnerf_torch.config import parse_args
    from customnerf_torch.engine.trainer import Trainer
    opt = parse_args(TINY + ["--workspace", str(tmp_path)] + list(extra))
    return Trainer(opt, device="cpu", log=kw.pop("log", lambda *_: None), **kw)


def _batches(tr, n):
    from customnerf_torch.data.base import NeRFDataset
    loader = NeRFDataset(tr.opt, "train", device="cpu").dataloader()
    return [loader.item(i % len(loader)) for i in range(n)]


def test_recon_step_stages_add_up_to_the_step(tmp_path, tracer):
    """A ``-O`` reconstruction step: every stage under ``recon.step``, the
    step's children and its self time adding up to it, the K1 backward
    inside the backward."""
    tr = _tiny_trainer(tmp_path)
    tr.update_extra_state()
    spans.reset()
    tr.train_step(_batches(tr, 1)[0])
    got = spans.collect()["spans"]
    assert RECON_STAGES <= set(got)
    assert all(got[n]["count"] == 1 for n in RECON_STAGES)
    step = got["recon.step"]
    kids = sum(got[n]["device_ms"] for n in ("render", "loss", "backward", "adam"))
    assert step["self_ms"] + kids == pytest.approx(step["device_ms"])
    assert got["backward"]["device_ms"] >= got["k1.bwd"]["device_ms"]


def test_editing_step_stages_and_the_backward_split(tmp_path, tracer, monkeypatch):
    """An LGIE editing step: ``edit.step`` › render, resize, VAE encode,
    UNet, loss, backward (› the VAE's, the resize's and the render's
    backward, split by gradient hooks; the K1 backward inside the render's)
    and Adam, with a pt-cache miss counted once a view."""
    flags = ["--pretrained", "--text", "a corgi", "--text_fg", "a dog",
             "--lambda_sd", "0.01", "--keep_bg", "100", "--random_bg_c", "--detach_bg",
             "--allow_random_guidance"]
    from customnerf_torch.config import parse_args
    guidance = build_tiny_guidance(parse_args(TINY + flags), tiny_stack())
    tr = _tiny_trainer(tmp_path, flags, guidance=guidance)
    before = dict(spans.counters)
    batch = _batches(tr, 1)[0]
    for _ in range(2):
        tr.global_step += 1
        tr.train_step(batch)
    got = spans.collect()
    s = got["spans"]
    assert EDIT_STAGES <= set(s)
    # the renderer's stages run in the pt render too (the pre-pass of a miss)
    render_stages = {"march", "eval", "composite"}
    assert all(s[n]["count"] == 2 for n in EDIT_STAGES - render_stages)
    assert all(s[n]["count"] > 2 for n in render_stages)
    assert got["counters"]["pt_render"] - before["pt_render"] == 1
    assert s["pt_render"]["host_count"] == 1 and s["pre_pass"]["host_count"] == 2
    occ = [(spans._names[i], depth) for i, _, _, depth, _ in
           spans.occurrences(list(spans._cpu_stamps))]
    depth = dict(occ)
    assert depth["edit.step"] == 0 and depth["backward"] == 1
    assert depth["vae_encode.bwd"] == depth["resize.bwd"] == depth["render.bwd"] == 2
    assert depth["k1.bwd"] == 3                   # inside the render's backward
    order = [n for n, _ in occ if n.endswith(".bwd") and n != "k1.bwd"][:3]
    assert order == ["vae_encode.bwd", "resize.bwd", "render.bwd"]
    kids = ("render", "resize", "vae_encode", "unet", "loss", "backward", "adam")
    assert (s["edit.step"]["self_ms"] + sum(s[n]["device_ms"] for n in kids)
            == pytest.approx(s["edit.step"]["device_ms"]))


def test_counters_of_a_training_run(tmp_path):
    """``Trainer.train`` counts refreshes and the checkpoint writer's time
    (``--ckpt_format orbax``) whether or not the tracer is on, and logs the
    run's counters in one line at its end."""
    lines = []
    tr = _tiny_trainer(tmp_path, ["--ckpt_format", "orbax"], log=lines.append)
    before = dict(spans.counters)
    tr.train(_batches(tr, 6), max_epochs=2)
    c = {k: v - before[k] for k, v in spans.counters.items() if k != "dropped_stamps"}
    assert c["refresh"] == tr.occ_state.iter_density == 6
    # saves: one before training, and before and after each epoch's
    # evaluation point (--eval_interval 1), each a snapshot and a save on
    # this thread, and a wait whenever a write was pending
    assert c["saver_write"] == 5 and c["saver_write_s"] > 0
    assert c["saver_block"] >= 10 and c["saver_block_s"] > 0
    assert c["capture"] == 0 and c["pt_render"] == 0          # no graphs on the CPU
    line = [l for l in lines if l.startswith("[INFO] counters:")]
    assert len(line) == 1 and "6 occupancy refreshes" in line[0]
    assert "5 writes" in line[0]


def test_tracer_is_part_of_the_graph_key(tmp_path):
    """A step captured with the tracer off holds no stamp: switching the
    tracer must give another graph key."""
    tr = _tiny_trainer(tmp_path)
    inputs = tr._recon_inputs(_batches(tr, 1)[0])
    spans.enable(False)
    off = tr._graph_key("recon", inputs)
    spans.enable(True, "cpu")
    try:
        assert tr._graph_key("recon", inputs) != off
    finally:
        spans.enable(False)
    assert tr._graph_key("recon", inputs) == off


def test_the_same_steps_with_the_tracer_on(tmp_path):
    """Two trainers from one seed, one with the tracer on: the same losses
    and parameters, bit for bit (the stamps change no number)."""
    runs = []
    for on in (False, True):
        spans.enable(on, "cpu")
        spans.reset()
        tr = _tiny_trainer(tmp_path / str(on))
        losses = [float(tr.train_one_epoch(_batches(tr, 4))) for _ in range(2)]
        runs.append((losses, [p.detach().clone() for p in tr.field.parameters()]))
    spans.enable(False)
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_card_stamps_are_placed_on_the_stamp_kernels(tracer, tmp_path, monkeypatch):
    """On a trace with the card's stamps, each stamp lands on the launch of
    the stamp kernel that took it, paired by the gaps between them, so a
    launch the profiler lost (the third here) shifts no other stamp.  The
    spans are nested on one track named ``cn spans``."""
    ids = _tags("step", "unet", "vae")
    at = [("step", 0, 0.0), ("unet", 0, 10.0), ("unet", 1, 23.4), ("vae", 0, 25.0),
          ("vae", 1, 33.0), ("step", 1, 40.0)]
    card = [(2 * ids[n] + e, 1_000_000 + int(t * 1e3)) for n, e, t in at]
    monkeypatch.setattr(spans, "_lib", object())
    monkeypatch.setattr(spans, "_card_stamps", lambda: (card, 0))
    launch = {"ph": "X", "cat": "kernel",
              "name": "(anonymous namespace)::cn_span_stamp_kernel(unsigned int)",
              "pid": 0, "tid": 7, "dur": 1.0}
    # the trace's clock is the card's + 500 µs, with ±0.2 µs of launch jitter
    events = [dict(launch, ts=ts) for ts in (540.3, 500.0, 510.2, 525.1, 533.1)]
    events.append({"ph": "X", "cat": "kernel", "name": "gemm", "pid": 0, "tid": 7,
                   "ts": 512.0, "dur": 5.0})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert spans.add_track(str(path)) == 3
    out = json.loads(path.read_text())["traceEvents"]
    track = [e for e in out if e.get("cat") == "cn_span"]
    got = {(e["name"], e["args"]["depth"]): (e["ts"], e["dur"]) for e in track}
    assert got[("step", 0)] == (500.0, pytest.approx(40.3))
    assert got[("unet", 1)] == (510.2, pytest.approx(13.4))
    assert got[("vae", 1)] == (525.1, pytest.approx(8.0))
    meta = [e for e in out if e.get("ph") == "M"]
    assert meta[0]["args"]["name"] == spans.TRACK and meta[0]["pid"] == track[0]["pid"]
    assert math.isclose(track[1]["args"]["self_us"], 13.4)    # ns → µs of the stamps


def test_card_stamps_follow_clock_drift_past_lost_launches():
    """The card's clock and the trace's run apart (here by 570 ppm, as an
    H100's did in an editing trace) and the profiler loses some launches,
    the first among them: every stamp whose launch is in the trace lands on
    it, and the others within a µs or two of where they ran.  Stamps come in
    a step's pattern, some under 2 µs apart."""
    import random
    rng = random.Random(3)
    pattern = [1.75, 71.5, 55.5, 12031.5, 156.25, 2.25, 282.0, 2.0, 121.0,
               23970.25, 2.0, 1.75, 3000.0, 2.25, 31000.0, 1.75]
    card, t = [], 0.0
    for k in range(3000):
        t += pattern[k % len(pattern)]
        card.append(t)
    launch = [c * (1 + 570e-6) + 777.0 + rng.uniform(-0.2, 0.2) for c in card]
    lost = set(rng.sample(range(3000), 20)) | {0}
    events = [{"ph": "X", "cat": "kernel", "name": spans.STAMP_KERNEL, "ts": launch[i]}
              for i in range(3000) if i not in lost]
    ts = spans._placed("cuda", [(0, int(c * 1e3)) for c in card], events)
    assert all(ts[i] == launch[i] for i in range(3000) if i not in lost)
    assert max(abs(ts[i] - launch[i]) for i in lost) < 2.0
