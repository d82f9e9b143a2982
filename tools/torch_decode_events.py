"""Host cost of one decode step of a checkout, on the card: full stablelm-3b
(32 layers, table_pack + TableFlash, seed-0 weights, batch 4, cache 256,
telemetry off), its host operator events under torch.profiler (CPU
activity), its kernel launches and its ms (mean of 10).  Prints one JSON
line.  An optional second argument names another approx mode (e.g.
``sharded_pack``, at the config's ``pack_shards``).  Compare two checkouts
in one call, in turns:

    for c in PARENT . . PARENT; do python3 tools/torch_decode_events.py $c; done

(unpack the parent with ``git archive`` into a git-ignored directory such as
``build/ab/parent``; each checkout builds its kernels into its own
``build/``).
"""

import dataclasses
import json
import sys
import time


def main(checkout: str, mode: str = "table_pack") -> None:
    sys.path.insert(0, checkout + "/src")
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import table_pack_lookup as K
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build_model, get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("stablelm-3b")
    cfg = base.replace(approx=dataclasses.replace(base.approx, mode=mode,
                                                  attn_table=True))
    m = build_model(cfg, "cuda")
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    reqs = make_requests(cfg.vocab, 8, 16)
    s0 = max(len(r.prompt) for r in reqs)
    rows = torch.zeros((4, s0), dtype=torch.int64, device="cuda")
    for j, r in enumerate(reqs[:4]):
        rows[j, s0 - len(r.prompt):] = torch.as_tensor(r.prompt, device="cuda")
    with torch.inference_mode():
        _, cache = m.prefill(params, {"tokens": rows}, m.init_cache(4, 256))
        tok = rows[:, -1:]
        pos = torch.full((4,), s0, dtype=torch.int32, device="cuda")

        def step():
            m.decode_step(params, tok, pos, cache)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        K.reset_launches()
        step()
        torch.cuda.synchronize()
        launches = {k: v for k, v in K.launches.items() if v}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step()
        torch.cuda.synchronize()
        events = len(prof.events())
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 10 * 1e3
    print(json.dumps({"checkout": checkout, "mode": mode, "events": events, "launches": launches,
                      "ms": round(ms, 3)}))


if __name__ == "__main__":
    main(*sys.argv[1:3])
