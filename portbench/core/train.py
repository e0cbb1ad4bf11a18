"""Training cells: the program's SISR trainer stepping on uint8 records held
on the card, each step handed one of a fixed set of draw sets (crops,
degradations, the ELBO's noise), the epoch fixed by the traffic file.

Set-up builds one trainer, hands it the benchmark's seeded weights, and
drives it through its first ``checked_steps`` steps with draw sets that
all differ, through the window's own call; those steps are the ones the
plain reference follows after the window.  A few more steps warm up, and
the window runs the same trainer on.
"""

from __future__ import annotations

import gc
import time

import torch

from . import generate
from .judge import scoped_precision, train_gaps
from .outcome import Outcome


def trainer_config(cell):
    from virnet_tpu_torch.train.loop_sisr import SISRTrainConfig

    arch, train = cell.config["arch"], cell.config["train"]
    fields = SISRTrainConfig.__dataclass_fields__
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in {**arch, **train}.items() if k in fields}
    return SISRTrainConfig(**kw, save_dir=str(cell.scratch / "train_save"))


def program(cell, device):
    """The program's trainer and its step: ``step(dataset, draws) ->
    aux``."""
    from virnet_tpu_torch.data.device_data import DeviceDataset
    from virnet_tpu_torch.train.loop_sisr import SISRTrainer

    trainer = SISRTrainer(trainer_config(cell), device=device)

    def dataset(records):
        return DeviceDataset(records.cpu().numpy(), device=device)

    def step(ds, draws):
        return trainer.run_step_device(ds, 0, noise=draws)
    return trainer, dataset, step


def _named(trainer) -> dict:
    return dict(trainer.model.named_parameters())


def run(cell, seed: int, seconds: float, trace: bool, device, t_process,
        make_program=None) -> Outcome:
    spec, train = cell.traffic, cell.config["train"]
    from ..reference.models import seeded_params

    marks = [time.perf_counter()]
    trainer, dataset, step = (make_program or program)(cell, device)
    params0 = seeded_params(cell.config["arch"], seed, device)
    trainer.model.load_state_dict(params0, strict=True)
    marks.append(time.perf_counter())
    records = generate.records(spec, seed, device)
    ds = dataset(records)
    draws = generate.sisr_step_draws(spec, train, seed, device)
    sync(device)
    marks.append(time.perf_counter())
    n_check = spec["checked_steps"]
    prog = dict(loss=[], terms=[])
    for t in range(n_check):
        aux = step(ds, draws[t])
        prog["loss"].append(float(aux["loss"]))
        prog["terms"].append({k: float(aux[k]) for k in
                              ("lh", "kl_rnet", "kl_snet", "kl_knet")})
        if t == 0:
            beta1 = trainer.optim.adam.defaults["betas"][0]
            state = trainer.optim.adam.state
            prog["grad1"] = {k: (state[p]["exp_avg"] / (1 - beta1)).clone()
                             if p in state else torch.zeros_like(p)
                             for k, p in _named(trainer).items()}
    prog["params"] = {k: p.detach().clone()
                      for k, p in _named(trainer).items()}
    marks.append(time.perf_counter())
    for t in range(spec["warmup_steps"]):
        step(ds, draws[(n_check + t) % len(draws)])
    sync(device)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - t_process

    first = n_check + spec["warmup_steps"]
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        step(ds, draws[(first + i) % len(draws)])
        i += 1
    sync(device)
    window_s = time.perf_counter() - t0
    batch = train["batch_size"]
    out = Outcome(setup_s=setup_s, attempted=i, window_s=window_s,
                  end_to_end=dict(train_samples_per_s=batch * i / window_s),
                  compute="bf16" if train["mixed_precision"] else "fp32")
    from .flops import forward_flops

    lr = -(-train["hr_size"] // train["sf"])
    out.unit_flops = 3 * forward_flops(cell.config["arch"], batch, lr, lr,
                                       train["sf"])
    if trace:
        from .trace import profile

        out.trace = profile(
            lambda k: step(ds, draws[(first + i + k) % len(draws)]),
            spec["profile"], device)
    out.read_memory(device)
    del trainer, step, ds
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.extra = dict(prog=prog, params0=params0, records=records,
                     draws=draws[:n_check])
    out.extra.update({f"setup_{k}_s": b - a for k, a, b in zip(
        ("before_trainer", "trainer", "inputs", "checked_steps",
         "warmup_steps"), [t_process] + marks, marks)})
    return out


def reference_steps(cell, out: Outcome, device, quant=None,
                    half_batch=False) -> dict:
    """The plain reference's first steps on the run's weights, records and
    draws; ``half_batch`` leaves out the second half of every batch (a
    fault the numbers must catch)."""
    from ..reference.sisr_train import train_steps

    draws = out.extra["draws"]
    if half_batch:
        draws = [_half(d) for d in draws]
    with scoped_precision(False):
        return train_steps(out.extra["params0"], out.extra["records"],
                           draws, cell.config["train"], cell.config["arch"],
                           quant)


def _half(tree):
    if isinstance(tree, dict):
        return {k: _half(v) for k, v in tree.items()}
    return tree[: tree.shape[0] // 2]


def judge(cell, out: Outcome, device) -> dict:
    ref = reference_steps(cell, out, device)
    return train_gaps(out.extra["prog"], ref, out.extra["params0"])


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
