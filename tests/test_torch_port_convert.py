"""The port's checkpoint conversion against the JAX package's on the CPU:
``to_jax_params`` leaf for leaf against ``convert_state_dict`` on the
demo weights of every preset, the round trip through ``from_jax_params``,
``save_torch_checkpoint`` against the JAX export, BatchNorm folding
(``merge_bn``) against the JAX fold and against the network it folds, and
the two command lines: ``cli/export_torch`` and ``cli/parity`` on a
stand-in reference tree (the reference checkout is not in the repo)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from virnet_tpu.convert import merge_bn as jmerge
from virnet_tpu.convert.torch_export import \
    save_torch_checkpoint as jax_save
from virnet_tpu.convert.torch_import import convert_state_dict
from virnet_tpu.models import build_model as jax_build_model
from virnet_tpu_torch.convert import (find_conv_bn_pairs, fold_bn,
                                      from_jax_params, load_pth,
                                      merge_bn_state_dict,
                                      save_torch_checkpoint, to_jax_params)

ROOT = Path(__file__).resolve().parents[1]
ZOO = ROOT / "model_zoo"
DEMOS = {"denoising-syn": "virnet_denoising_syn_demo.pth",
         "denoising-real": "virnet_denoising_real_demo.pth",
         "sisr x2": "virnet_sisr_x2_demo.pth",
         "sisr x4": "virnet_sisr_x4_demo.pth"}


def _raw(path):
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt.get("model_state_dict", ckpt)


# ---------------------------------------------------------------------------
# to_jax_params / from_jax_params / save_torch_checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(DEMOS))
def test_to_jax_params_is_convert_state_dict_and_round_trips(preset):
    """On each preset's demo weights (full width; the x2 and x4 SISR
    files): the same tree as the JAX convert_state_dict, every leaf a
    float32 array with the same bits; from_jax_params gives the state dict
    back bit for bit; load_pth of a file without BatchNorm is the file
    cast to fp32, as before merge_bn existed."""
    path = ZOO / DEMOS[preset]
    sd = load_pth(path)
    raw = _raw(path)
    assert sd.keys() == {k.removeprefix("module.") for k in raw}
    for k, v in raw.items():
        assert torch.equal(sd[k.removeprefix("module.")], v.float()), k
    ours = to_jax_params(sd)
    want = convert_state_dict(sd, jax_build_model(preset.split()[0]))
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    back = from_jax_params(ours)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("preset", ["denoising-real", "sisr x2"])
def test_save_torch_checkpoint_writes_what_the_jax_export_writes(preset,
                                                                 tmp_path):
    """The same epoch, keys and tensors as the JAX package's
    save_torch_checkpoint of the same weights; the file loads strict=True
    into the port's Restorer."""
    from virnet_tpu_torch.eval.engine import Restorer

    task = preset.split()[0]
    sd = load_pth(ZOO / DEMOS[preset])
    save_torch_checkpoint(tmp_path / "port.pth", sd, epoch=3)
    jax_save(tmp_path / "jax.pth", to_jax_params(sd)["params"],
             jax_build_model(task), epoch=3)
    a = torch.load(tmp_path / "port.pth", weights_only=True)
    b = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert a["epoch"] == b["epoch"] == 3
    assert a["model_state_dict"].keys() == b["model_state_dict"].keys()
    for k, v in b["model_state_dict"].items():
        assert v.dtype == torch.float32
        assert torch.equal(a["model_state_dict"][k], v), k
    Restorer(task, ckpt_path=tmp_path / "port.pth", device="cpu")


# ---------------------------------------------------------------------------
# merge_bn
# ---------------------------------------------------------------------------

class _BNNet(nn.Module):
    """Conv+BN pairs of every layout: a non-square conv, a square conv, a
    non-square ConvTranspose2d, a BatchNorm without affine parameters,
    and a Linear + BatchNorm1d head."""

    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8), nn.ReLU(),
            nn.Conv2d(8, 8, 3, padding=1), nn.BatchNorm2d(8), nn.ReLU(),
            nn.ConvTranspose2d(8, 4, 2, stride=2),
            nn.BatchNorm2d(4, affine=False))
        self.head = nn.Sequential(nn.Linear(16, 5), nn.BatchNorm1d(5))

    def forward(self, x, v):
        return self.body(x), self.head(v)


class _PlainNet(nn.Module):
    """_BNNet with every BatchNorm folded away (the same keys otherwise;
    the ConvTranspose2d gains the bias the fold gives it)."""

    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(3, 8, 3, padding=1), nn.Identity(), nn.ReLU(),
            nn.Conv2d(8, 8, 3, padding=1), nn.Identity(), nn.ReLU(),
            nn.ConvTranspose2d(8, 4, 2, stride=2))
        self.head = nn.Sequential(nn.Linear(16, 5))

    def forward(self, x, v):
        return self.body(x), self.head(v)


def _seeded_bn_net(seed=0) -> _BNNet:
    torch.manual_seed(seed)
    net = _BNNet()
    for m in net.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 2.0)
            m.num_batches_tracked.fill_(7)
            if m.affine:
                m.weight.data.uniform_(0.5, 1.5)
                m.bias.data.uniform_(-0.2, 0.2)
    return net.eval()


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def test_merge_bn_is_the_jax_fold_and_folds_the_network():
    """find_conv_bn_pairs as the JAX package's; merge_bn_state_dict (the
    ConvTranspose2d named) gives the JAX result bit for bit (the JAX
    package reads the non-square layouts off the shapes and takes dim 0
    for the square conv, right for it); the folded weights in a network
    without BatchNorm give the eval-mode BatchNorm network's outputs
    within 1e-6 relative; each fold_bn equals the JAX fold_bn."""
    net = _seeded_bn_net()
    sd = net.state_dict()
    pairs = find_conv_bn_pairs(sd)
    assert pairs == jmerge.find_conv_bn_pairs(_np(sd))
    assert pairs == [("body.0", "body.1"), ("body.3", "body.4"),
                     ("body.6", "body.7"), ("head.0", "head.1")]
    ours = merge_bn_state_dict(sd, transposed=["body.6"])
    want = jmerge.merge_bn_state_dict(_np(sd))
    assert ours.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(ours[k].numpy(), want[k], err_msg=k)
    plain = _PlainNet()
    plain.load_state_dict(ours, strict=True)
    x, v = torch.rand(2, 3, 6, 5), torch.rand(4, 16)
    with torch.no_grad():
        for got, ref in zip(plain.eval()(x, v), net(x, v)):
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    for conv, bn, tr in (("body.0", "body.1", False),
                         ("body.6", "body.7", True),
                         ("head.0", "head.1", False)):
        a = fold_bn(sd[f"{conv}.weight"], sd.get(f"{conv}.bias"),
                    sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                    sd.get(f"{bn}.weight"), sd.get(f"{bn}.bias"),
                    transposed=tr)
        b = jmerge.fold_bn(*(None if t is None else t.numpy() for t in (
            sd[f"{conv}.weight"], sd.get(f"{conv}.bias"),
            sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
            sd.get(f"{bn}.weight"), sd.get(f"{bn}.bias"))), transposed=tr)
        for t, w in zip(a, b):
            np.testing.assert_array_equal(t.numpy(), w)


def test_merge_bn_square_conv_transpose_is_ambiguous(tmp_path):
    """A square ConvTranspose2d before a BatchNorm: from the shape alone
    the fold raises (the JAX package folds dim 0 there, which is wrong:
    its network output is off); named, it folds dim 1 and the network
    agrees.  load_pth applies the fold to a file that holds pairs."""
    torch.manual_seed(1)
    net = nn.Sequential(nn.ConvTranspose2d(6, 6, 2, stride=2),
                        nn.BatchNorm2d(6)).eval()
    net[1].running_mean.uniform_(-0.5, 0.5)
    net[1].running_var.uniform_(0.5, 2.0)
    net[1].weight.data.uniform_(0.5, 1.5)
    sd = net.state_dict()
    with pytest.raises(ValueError, match="cannot tell"):
        merge_bn_state_dict(sd)
    folded = merge_bn_state_dict(sd, transposed=["0"])
    plain = nn.Sequential(nn.ConvTranspose2d(6, 6, 2, stride=2)).eval()
    plain.load_state_dict(folded, strict=True)
    x = torch.rand(1, 6, 3, 4)
    with torch.no_grad():
        torch.testing.assert_close(plain(x), net(x), rtol=1e-6, atol=1e-6)
        jax_way = {k: torch.from_numpy(v) for k, v in
                   jmerge.merge_bn_state_dict(_np(sd)).items()}
        plain.load_state_dict(jax_way, strict=True)
        assert (plain(x) - net(x)).abs().max() > 1e-3
    torch.save({"model_state_dict": {f"module.{k}": v
                                     for k, v in sd.items()}},
               tmp_path / "bn.pth")
    with pytest.raises(ValueError, match="cannot tell"):
        load_pth(tmp_path / "bn.pth")
    loaded = load_pth(tmp_path / "bn.pth", transposed=["0"])
    assert loaded.keys() == folded.keys()
    assert all(torch.equal(loaded[k], folded[k].float()) for k in folded)


# ---------------------------------------------------------------------------
# the command lines
# ---------------------------------------------------------------------------

def test_export_torch_cli_writes_a_pth_the_restorer_loads(tmp_path):
    """A trainer run directory (the trainers' checkpoint format,
    train/checkpoint.py) to a reference .pth: the latest or a given step,
    loading strict=True into Restorer and through load_pth bit for bit;
    a run of another preset's weights and a folder without checkpoints
    are refused."""
    from virnet_tpu_torch.cli import export_torch
    from virnet_tpu_torch.eval.engine import Restorer
    from virnet_tpu_torch.train.checkpoint import CheckpointManager

    sd = load_pth(ZOO / DEMOS["denoising-syn"])
    run = tmp_path / "run"
    mngr = CheckpointManager(run)
    for step in (1, 2):
        mngr.save(step, dict(params={k: v * step for k, v in sd.items()},
                             opt_state={}, step=10 * step, epoch=step))
    for step, scale in ((None, 2), (1, 1)):
        out = tmp_path / f"out{step}.pth"
        argv = ["--task", "denoising-syn", "--run_dir", str(run), "--out",
                str(out)] + ([] if step is None else ["--step", str(step)])
        export_torch.main(argv)
        got = load_pth(out)
        assert torch.load(out, weights_only=True)["epoch"] == scale
        assert all(torch.equal(got[k], sd[k] * scale) for k in sd)
        Restorer("denoising-syn", ckpt_path=out, device="cpu")
    with pytest.raises(RuntimeError):
        export_torch.main(["--task", "denoising-real", "--run_dir",
                           str(run), "--out", str(tmp_path / "x.pth")])
    with pytest.raises(SystemExit, match="no trainer checkpoints"):
        export_torch.main(["--task", "denoising-syn", "--run_dir",
                           str(tmp_path / "none"), "--out",
                           str(tmp_path / "y.pth")])


_STAND_IN = '''"""A stand-in for the reference's networks/VIRNet.py: the port's model
behind the reference's constructor and NCHW interface, its output moved
by OFFSET."""
import torch

from virnet_tpu_torch.models import build_model

OFFSET = {offset}


class VIRAttResUNet(torch.nn.Module):
    def __init__(self, im_chn, sigma_chn, n_feat, dep_S, n_resblocks,
                 noise_cond, extra_mode, noise_avg):
        super().__init__()
        task = "denoising-syn" if sigma_chn == 1 else "denoising-real"
        model = build_model(task, conv_impl="torch")
        self.SNet, self.RNet = model.SNet, model.RNet
        self._model = [model]

    def forward(self, x):
        mu, sigma = self._model[0](x.permute(0, 2, 3, 1))
        return mu.permute(0, 3, 1, 2) + OFFSET, sigma


class VIRAttResUNetSR(torch.nn.Module):
    def __init__(self, **kwargs):
        raise NotImplementedError("the stand-in serves denoising only")
'''


def _stand_in(root: Path, offset: float) -> Path:
    (root / "networks").mkdir(parents=True)
    (root / "networks" / "__init__.py").write_text("")
    (root / "networks" / "VIRNet.py").write_text(
        _STAND_IN.format(offset=offset))
    return root


def test_parity_cli_on_a_stand_in_reference(tmp_path, capsys):
    """cli.parity on the CPU against a stand-in reference tree holding the
    port's own model (identical weights): PASS, exit 0, the three iid
    cases scored; a stand-in whose output is off by 0.02 fails the
    ±0.01 dB goal (exit 1); a missing checkpoint is reported (exit 2)."""
    import cv2

    from virnet_tpu_torch.cli import parity

    data = tmp_path / "data" / "CBSD68"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        cv2.imwrite(str(data / f"im{i}.png"),
                    (rng.random((24, 32, 3)) * 255).astype(np.uint8))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        outs = []
        for offset in (0.0, 0.02):
            ref = _stand_in(tmp_path / f"ref{offset}", offset)
            rc = parity.main([
                "--task", "denoising-syn", "--ref_dir", str(ref),
                "--ckpt_path", str(ZOO / DEMOS["denoising-syn"]),
                "--data_root", str(tmp_path / "data"), "--limit", "1",
                "--noise_types", "iid", "--device", "cpu"])
            outs.append((rc, capsys.readouterr().out))
    finally:
        torch.set_num_threads(threads)
    (rc0, out0), (rc1, out1) = outs
    assert rc0 == 0 and "PASS" in out0 and out0.count("CBSD68/") == 3, out0
    assert "+0.0000" in out0
    assert rc1 == 1 and "FAIL: 3 case(s)" in out1, out1
    rc = parity.main(["--task", "denoising-syn", "--ref_dir", str(tmp_path),
                      "--ckpt_path", str(tmp_path / "none.pth")])
    assert rc == 2 and "skipped" in capsys.readouterr().out
