#!/usr/bin/env python3
"""How often a torch.profiler trace of one commit-phase graph replay loses
device records, and where: with the lead-in alone before the replay, and
behind a warm replay of the same instance (chip_smoke.py's `traced_run`).

    python3 tools/torch_trace_loss.py [--traces N]

Three cells of chip_smoke.py phases 13 and 14 (pow_bits 20, log_blowup 4):
2^24 felts / 20 queries on one device, the same over 8 virtual shards of
the card, and the batched commit phase of 8 x 2^20 felts / 64 queries.
After three warm proofs, N traces of each form in turns (default 12), each
in a `torch.profiler` trace of its own (the device's activity only):

- "lead-in": `lead_in` then one replay; the replay's records are those
  after the last lead-in kernel, or all of them if the trace lost it;
- "warm": `traced_run` (a warm replay, finished, then `lead_in` and the
  counted replay); the counted records are `counted_events`'.

For each trace it checks the proof bytes and compares the kernels of the
counted records with the launches the capture recorded; for "warm" also
the whole trace against twice them, which shows losses that fell on the
warm replay. Prints each trace with a loss (which kernels, the first
records that survived) and a tally per cell and form; the first line gives
the card's `nvidia-smi` name and power limit. Exits nonzero without CUDA or
when a "warm" trace's counted replay lost a record.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import sys

from torch_harness import REPO, card


def smoke():
    """This checkout's chip_smoke.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location("frieda_chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cells(cs, dev):
    """[(name, run, finish, recorded)]: `run()` dispatches one replay,
    `finish(result)` its proof bytes, `recorded(result)` the capture's
    launches."""
    from frieda_tpu_torch.config import FriConfig, PcsConfig
    from frieda_tpu_torch.core import fri
    from frieda_tpu_torch.parallel import sharding
    from frieda_tpu_torch.utils.convert import from_numpy_u32
    from frieda_tpu_torch.utils.packing import log_total_for, pad_to_words, upload_words

    out = []
    cfg24 = PcsConfig(pow_bits=20, fri_config=FriConfig(cs.LOG_BLOWUP, 0, 20))
    data = cs.synthetic_data(cs.felt_bytes(24))
    log24 = log_total_for(len(data))
    words = from_numpy_u32(pad_to_words(data, log24), dev)
    mesh8 = sharding.make_mesh(1, 8, devices=[dev] * 8)
    for name, mesh in (("2^24 felts / 20 q", None), ("2^24 felts / 20 q over 8 virtual shards", mesh8)):
        out.append((name, lambda mesh=mesh: fri.dispatch_words(words[None], log24, [7], cfg24, mesh)[0],
                    lambda c: fri.finish_proof(c, log24, cfg24)[1].to_bytes(), lambda c: c._lease.launches))
    cfg20 = PcsConfig(pow_bits=20, fri_config=FriConfig(cs.LOG_BLOWUP, 0, 64))
    datas = [cs.synthetic_data(cs.felt_bytes(20), k) for k in range(8)]
    log20 = log_total_for(len(datas[0]))
    _, words8 = upload_words(datas, log20, dev)

    def batched():
        inst = fri._fri_commit_fn(log20, cfg20, True, dev, blobs=8)  # captured on the cell's first call
        inst.words.copy_(words8)
        return inst.run(list(range(1, 9)))

    out.append(("batched 8 x 2^20 felts / 64 q", batched,
                lambda cs_: [fri.finish_proof(c, log20, cfg20)[1].to_bytes() for c in cs_],
                lambda cs_: cs_[0]._lease.launches))
    return out


def kernels(cs, events) -> dict:
    out: dict = {}
    for e in events:
        m = cs.KERNEL_OF_WRAPPER.search(e.name())
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def first_records(cs, events, n: int = 6) -> list:
    t0 = events[0].start_ns() if events else 0
    named = []
    for e in events[:n]:
        m = cs.KERNEL_OF_WRAPPER.search(e.name())
        named.append((m.group(1) if m else e.name()[:24], round((e.start_ns() - t0) / 1e3, 1)))
    return named


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--traces", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_loss: CUDA is not available", file=sys.stderr)
        return 1
    from frieda_tpu_torch.core import fri
    from frieda_tpu_torch.ops import _build

    cs = smoke()
    _build.build()
    _build.library()
    dev = torch.device("cuda", 0)
    print(f"[loss] card {card()}", flush=True)
    tally, bad = {}, 0
    for name, run, finish, recorded in cells(cs, dev):
        want = finish(run())
        for _ in range(2):
            assert finish(run()) == want, f"{name}: a warm proof differs"

        def settle(result, name=name, finish=finish, want=want):
            assert finish(result) == want, f"{name}: the warm replay's proof differs"
            gc.collect()

        for i in range(args.traces):
            for form in ("lead-in", "warm") if i % 2 == 0 else ("warm", "lead-in"):
                if form == "warm":
                    prof, result = cs.traced_run(run, settle)
                else:
                    torch.cuda.synchronize()
                    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                        cs.lead_in()
                        result = run()
                        torch.cuda.synchronize()
                rec = dict(recorded(result))
                assert finish(result) == want, f"{name}: the traced replay's proof differs"
                del result
                counted = cs.counted_events(prof)
                got = kernels(cs, counted)
                lost = {k: v - got.get(k, 0) for k, v in rec.items() if v != got.get(k, 0)}
                note = ""
                if form == "warm":
                    whole = kernels(cs, [e for e in prof.profiler.kineto_results.events()
                                         if e.device_type() == torch.autograd.DeviceType.CUDA])
                    early = {k: 2 * v - whole.get(k, 0) for k, v in rec.items() if 2 * v != whole.get(k, 0)}
                    note = f"; the whole trace lost {early}" if early else ""
                    bad += bool(lost)
                counts = tally.setdefault((name, form), [0, 0, 0])
                counts[0] += 1
                counts[1] += bool(lost)
                counts[2] += bool(note)
                if lost or note:
                    print(f"[loss] {name}, {form} #{i}: the counted replay lost {lost or 'nothing'}{note}; "
                          f"the first counted records (kernel, us from the first) {first_records(cs, counted)}",
                          flush=True)
        fri.clear_commit_graphs()
        torch.cuda.empty_cache()
    print("[loss] (cell, form): traces, traces whose counted replay lost a record, traces that lost one "
          "anywhere (warm form)", flush=True)
    for key, counts in tally.items():
        print(f"[loss]   {key}: {counts}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
