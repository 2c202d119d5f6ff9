"""Which operations make the port's CTC training step differ between runs
on one NVIDIA GPU.

    python3 profile_determinism.py

Builds the flagship trainer of ``chip_smoke.py`` (``training_setup``: B=32
seeded synthetic utterances of 9.3-10 s, attention kernels selected) and takes
the step-1 gradient of one batch from one state 4 times each: as the trainer
runs, with ``torch.backends.cudnn.deterministic``, and under
``torch.use_deterministic_algorithms(True, warn_only=True)``, whose warnings
name the operations that have no deterministic implementation. Then it takes
``F.ctc_loss``'s gradient at the step's shapes (B=32, 250 frames, 40 labels)
6 times at vocabularies 31 and 500. Prints, for each repeat, whether the loss,
the gradient norm and every parameter's gradient equal the first run's, and
the card's name and power limit. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import os
import subprocess
import sys
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def gradients(trainer, state, batch, reps: int) -> list:
    """``reps`` x (loss, {parameter name: gradient}) of one step from ``state``."""
    import torch

    named = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
    out = []
    for _ in range(reps):
        aug, drop = trainer.step_streams(state)
        trainer.model.train()
        loss, _ = trainer.loss_and_metrics(trainer._to_device(dict(batch)), aug, drop, state.step)
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        out.append((loss.item(), {n: g for (n, _), g in zip(named, grads) if g is not None}))
    return out


def report(tag: str, runs: list) -> None:
    import torch

    def norm(grads):
        return float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values())))

    loss0, grads0 = runs[0]
    for i, (loss, grads) in enumerate(runs[1:], 1):
        differ = [n for n in grads0 if not torch.equal(grads0[n], grads[n])]
        print(f"{tag} run {i}: loss equal {loss == loss0}, grad norm {norm(grads0)!r} vs {norm(grads)!r}, "
              f"{len(differ)} parameters' gradients differ: {differ[:12]}", flush=True)


def main() -> None:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("profile_determinism.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    trainer, batches = chip_smoke.training_setup(seed=0, batch_size=32, n_batches=1)
    state = trainer.init_state()
    report("as the trainer runs", gradients(trainer, state, batches[0], 4))
    torch.backends.cudnn.deterministic = True
    report("cudnn.deterministic", gradients(trainer, state, batches[0], 4))
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        report("use_deterministic_algorithms", gradients(trainer, state, batches[0], 4))
    print("warnings:", sorted({str(w.message)[:120] for w in caught}), flush=True)
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False

    gen = torch.Generator(device="cuda").manual_seed(0)
    for vocab in (31, 500):
        logits = torch.randn(32, 250, vocab, device="cuda", generator=gen)
        labels = torch.randint(1, vocab, (32, 40), device="cuda", generator=gen)
        frames, lengths = torch.full((32,), 250, device="cuda"), torch.full((32,), 40, device="cuda")
        grads = []
        for _ in range(6):
            x = logits.clone().requires_grad_()
            loss = F.ctc_loss(x.log_softmax(-1).transpose(0, 1), labels, frames, lengths, blank=0,
                              reduction="mean", zero_infinity=True)
            grads.append(torch.autograd.grad(loss, x)[0])
        print(f"F.ctc_loss at V={vocab}: gradients bit-equal to the first run's over 6 runs: "
              f"{[torch.equal(grads[0], g) for g in grads[1:]]}, largest difference "
              f"{max(float((grads[0] - g).abs().max()) for g in grads[1:]):.3e}", flush=True)


if __name__ == "__main__":
    main()
