#!/usr/bin/env python
"""Where a decode step stops being batch-invariant on the card.

Builds a decode model's step program (``serving.decode_models``), runs it
op by op on one batch of B rows and on one of its rows alone, from the
same seeded parameters and inputs, and prints for each B the first op
whose output row differs from the lone row's (bit for bit), with the
largest difference; a batch-invariant step prints that every op agrees.
The static-against-continuous gate of ``chip_smoke.py`` phase 29 rests
on this property (ROADMAP.md §C, C7).

    python paddle_tpu_torch/tools/decode_invariance.py [attention_lm|gru_lm]
"""
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

CAP, ROW = 16, 3


def main(argv) -> int:
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import decode_models as zoo
    if not torch.cuda.is_available():
        print("decode_invariance: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    family = argv[0] if argv else "attention_lm"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip() or "nvidia-smi failed"
    _, step, _ = getattr(zoo, family)()
    main_prog, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main_prog, startup):
        (tok, pos, states), _ = step()
    scope, exe = pt.Scope(), pt.Executor(pt.CUDAPlace(0))
    startup.random_seed = 4
    exe.run(startup, scope=scope)
    ops = main_prog.desc.block(0).ops
    names = list(dict.fromkeys(n for o in ops for n in o.output_names() if n))
    rs = np.random.RandomState(2)
    for b in (2, 4, 8):
        feed = {tok.name: rs.randint(1, zoo.VOCAB, (b,) + tuple(tok.shape[1:])).astype(np.int64)}
        if pos is not None:
            feed[pos.name] = rs.randint(0, CAP, (b, 1)).astype(np.int32)
        for s in states:
            feed[s.name] = rs.randn(*((b,) + tuple(CAP if d < 0 else d for d in s.shape[1:]))
                                    ).astype(np.float32)
        r = ROW % b
        one = {k: v[r:r + 1] for k, v in feed.items()}
        wide = dict(zip(names, exe._run_eager(main_prog, feed=feed, fetch_list=names,
                                              scope=scope)))
        solo = dict(zip(names, exe._run_eager(main_prog, feed=one, fetch_list=names,
                                              scope=scope)))
        for i, o in enumerate(ops):
            bad = [n for n in o.output_names()
                   if n and not np.array_equal(wide[n][r:r + 1], solo[n])]
            if bad:
                diff = float(np.abs(wide[bad[0]][r:r + 1].astype(np.float64)
                                    - solo[bad[0]]).max())
                print(f"{family} batch {b}: op {i} ({o.type}) -> {bad} is the first whose row "
                      f"differs from the row alone, max abs {diff:.3e} [{card}]")
                break
        else:
            print(f"{family} batch {b}: every op's row bit-equal to the row alone [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
