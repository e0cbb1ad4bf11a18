"""Each fault a cell can have, planted underneath the timed path, makes a
run come out not correct; the unbroken run comes out correct.  Runs on
the CPU at a tiny size with the cells' own limits (checks/<cell>.json),
skipping only the harness's look for a card."""

import json

import pytest
import torch

from portbench.tests.helpers import REPO, run_cell, tiny_root

SERVING = ["denoising_syn.serve_batch_bf16", "denoising_syn.serve_image_fp32"]
TRAINING = "sisr_x4.train_bf16"


def limits(cell):
    return json.loads((REPO / "portbench/checks" / f"{cell}.json"
                       ).read_text())["limits"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    cells = SERVING + [TRAINING]
    return tiny_root(tmp_path_factory.mktemp("faults"),
                     {c: limits(c) for c in cells})


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def alter_answers(monkeypatch):
    """Every restored batch's first image comes back upside down."""
    from virnet_tpu_torch.eval.engine import Restorer

    orig = Restorer.restore_batch

    def altered(self, x):
        y = orig(self, x).clone()
        y[0] = y[0].flip(0)
        return y
    monkeypatch.setattr(Restorer, "restore_batch", altered)


def state_unchanged(monkeypatch):
    """The optimizer step computes its norms and updates nothing."""
    from virnet_tpu_torch.train import optim

    monkeypatch.setattr(optim.SubnetAdam, "step",
                        lambda self: optim.subnet_grad_norms(self.subnets))


def half_batch(monkeypatch):
    """The loss is the mean over the first half of the batch alone."""
    from virnet_tpu_torch.train import loop_sisr

    orig = loop_sisr.elbo_sisr

    def half(mu, sigma_est, kinfo_est, im_hr, im_lr, sigma_prior, alpha0,
             kinfo_gt, *args, noise=None, **kw):
        n = mu.shape[0] // 2
        noise = {k: v[:n] for k, v in noise.items()}
        return orig(mu[:n], sigma_est[:n], kinfo_est[:n], im_hr[:n],
                    im_lr[:n], sigma_prior[:n], alpha0, kinfo_gt[:n], *args,
                    noise=noise, **kw)
    monkeypatch.setattr(loop_sisr, "elbo_sisr", half)


@pytest.mark.parametrize("cell", SERVING + [TRAINING])
def test_a_sound_run_is_correct(root, cell):
    rc, res, err = run_cell(root, cell)
    assert rc == 0 and res["correct"] is True, err[-800:]


@pytest.mark.parametrize("cell,fault", [(c, alter_answers) for c in SERVING]
                         + [(TRAINING, state_unchanged),
                            (TRAINING, half_batch)],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_fault_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    rc, res, err = run_cell(root, cell)
    assert rc == 0 and res["correct"] is False, err[-800:]
    assert res["failed"] >= 1
