"""The port's command-line entry points (go_with_the_flows_tpu_torch/cli),
called in process through `main(argv)` with `--device cpu` on tiny
widths and synthetic h5 data (cubes from the JAX package's
data/synthetic.py, renderings of 20 x 20 pixels): train_ae for two
epochs and a resume, evaluate_ae in generating, autoencoding (with the
h5 dump read back), reconstruction and interpolation (its h5 dump read
back), reconstruct_ae's .npy dump, and train_svr. Without `--device`, every
command asks for the card and fails here.

Tolerance: none; the checks are on shapes, files, keys, ranges and
exact equality of what is dumped with what the datasets give.
"""

import os

import h5py
import numpy as np
import pytest
import torch

from go_with_the_flows_tpu.data.synthetic import (
    write_synthetic_images_h5,
    write_synthetic_meshes_h5,
)
from go_with_the_flows_tpu_torch.cli import (
    evaluate_ae,
    import_torch_ckpt,
    reconstruct_ae,
    train_ae,
    train_svr,
)
from go_with_the_flows_tpu_torch.train.checkpoints import _ckpt_dir
from go_with_the_flows_tpu_torch.utils.config import (
    load_config,
    write_config,
)

TINY_CONFIG = dict(
    batch_size=4, beta1=0.9, chosen_label=None, cloud_center=False,
    cloud_noise=False, cloud_noise_scale=0.002, cloud_random_rotate=False,
    cloud_recenter2orig=False, cloud_rescale2orig=False, cloud_scale=True,
    cloud_scale_scale=2.0, cloud_size=32, cloud_translate=False,
    cloud_translate_shift=[0.0, 0.0, 0.0], cycle_length=4,
    deterministic=False, g_latent_space_size=8, g_posterior_n_layers=1,
    g_prior_n_features=8, g_prior_n_flows=2, gent_weight=1.0,
    gnll_weight=1.0, logging=True, logging_img=False,
    logging_img_frequency=1, max_beta2=0.99, max_lr=1e-3,
    meshes_fname="meshes.h5", min_beta2=0.99, min_lr=1e-3,
    n_components=2, n_epochs=2, num_workers=0, p_decoder_base_type="free",
    p_decoder_base_var=-3.9551, p_decoder_n_features=8,
    p_decoder_n_flows=2, p_latent_space_size=3, p_prior_n_layers=1,
    params_reduce_mode="none", pc_enc_init_n_channels=3,
    pc_enc_init_n_features=8, pc_enc_n_features=[8, 16], pnll_weight=1.0,
    resume=False, resume_optimizer=False, saving_mode=True, shuffle=True,
    train_mode="p_rnvp_mc_g_rnvp_vae", util_mode="training", wd=1e-6,
    weights_type="learned_weights",
)
SVR_CONFIG = dict(
    TINY_CONFIG, train_mode="p_rnvp_mc_g_rnvp_vae_ic", batch_size=16,
    meshes_fname="svr_meshes.h5", images_fname="images.h5",
    image_resize=True, image_size=[24, 24],
    image_pad=False, image_pad_size=[0, 0], image_add_grayscale=True,
    image_remove_alpha=True, image_normalize=True,
    image_means=[0.1, 0.1, 0.1, 0.1], image_stds=[0.3, 0.3, 0.3, 0.3],
    image_noise=False, image_noise_scale=0.02, g_prior_n_layers=1)
N_SHAPES = 8


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Synthetic data, and train_ae run for 2 epochs on it."""
    d = tmp_path_factory.mktemp("cli")
    write_synthetic_meshes_h5(str(d / "meshes.h5"), n_shapes=N_SHAPES)
    write_synthetic_meshes_h5(str(d / "svr_meshes.h5"), n_shapes=2,
                              parts=("train", "test"))
    write_synthetic_images_h5(str(d / "images.h5"), n_shapes=2,
                              parts=("train", "test"), hw=20)
    for name, config in (("config.yaml", TINY_CONFIG),
                         ("svr.yaml", SVR_CONFIG)):
        write_config(dict(config, path2data=str(d),
                          path2save=str(d / "results")), str(d / name))
    state, timings = train_ae.main([
        str(d / "config.yaml"), "smoke", "2", "0.001", "--weights_type",
        "learned_weights", "--warmup_epoch", "1", "--jobid", "t1",
        "--device", "cpu"])
    return {"dir": d, "exp": str(d / "results" / "smoke_t1"),
            "state": state, "timings": timings}


def test_train_ae_two_epochs(workdir):
    exp = workdir["exp"]
    # the generated logging_path was written back into the config file
    assert load_config(str(workdir["dir"] / "config.yaml"))[
        "logging_path"] == exp
    saved = load_config(os.path.join(exp, "config.yaml"))
    assert saved["model_name"] == "smoke.ckpt" and saved["n_epochs"] == 2
    assert saved["min_lr"] == saved["max_lr"] == 0.001
    for name in ("smoke.ckpt", "best_model_smoke.ckpt"):
        assert os.path.isfile(os.path.join(_ckpt_dir(exp, name),
                                           "checkpoint.pt"))
    assert [t["epoch"] for t in workdir["timings"]] == [0, 1]
    assert [t["steps"] for t in workdir["timings"]] == [2, 2]
    assert workdir["state"].step == 4
    metrics = workdir["state"].val_metrics
    assert set(metrics) == {"loss", "pnll", "gnll", "gent"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert any(f.startswith("events") for f in
               os.listdir(os.path.join(exp, "log")))


def test_train_ae_resume(workdir):
    """--resume picks the checkpoint of epoch 2 up and runs epoch 2
    alone; the model it starts from is the one saved."""
    saved = torch.load(os.path.join(_ckpt_dir(workdir["exp"], "smoke.ckpt"),
                                    "checkpoint.pt"), weights_only=True)
    assert saved["epoch"] == 2
    state, timings = train_ae.main([
        str(workdir["dir"] / "config.yaml"), "smoke", "3", "0.001",
        "--weights_type", "learned_weights", "--warmup_epoch", "1",
        "--jobid", "t1", "--resume", "--resume_optimizer", "--device",
        "cpu"])
    assert [t["epoch"] for t in timings] == [2]
    assert state.step == saved["step"] + 2


def _evaluate(workdir, mode, *flags, exp=None, name="smoke.ckpt",
              part="test"):
    return evaluate_ae.main([exp or workdir["exp"], name, part, "32", "32",
                             mode, "--batch_size", "4", *flags, "--device",
                             "cpu"])


def test_evaluate_generating(workdir, capsys):
    model, results = _evaluate(workdir, "generating", "--cd", "--emd",
                               "--jsd", "--reps", "2",
                               "--unit_scale_evaluation")
    assert len(results) == 2
    keys = {"jsd", "cd_mmds", "cd_covs", "cd_1nns", "emd_mmds", "emd_covs",
            "emd_1nns"}
    for res in results:
        assert set(res) == keys
        assert all(np.isfinite(v) for v in res.values())
        assert 0.0 <= res["jsd"] <= 100.0 + 1e-9
    out = capsys.readouterr().out
    assert "==== mean ± std over 2 reps ====" in out
    assert "JSD:" in out and "MMD-EMD:" in out


def test_evaluate_autoencoding_with_h5_dump(workdir):
    model, (res,) = _evaluate(workdir, "autoencoding", "--cd", "--emd",
                              "--f1", "--save")
    assert set(res) == {"cd", "emd", "f1_0.0010"}
    assert all(np.isfinite(v) for v in res.values())
    path = os.path.join(workdir["exp"],
                        "smoke_test_32_32_clouds_autoencoding.h5")
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["gt_clouds", "sampled_clouds", "sampled_labels"]
        sampled, gts = f["sampled_clouds"][()], f["gt_clouds"][()]
        labels = f["sampled_labels"][()]
    assert sampled.shape == gts.shape == (N_SHAPES, 3, 32)
    assert labels.shape == (N_SHAPES, 32) and labels.dtype == np.int8
    assert labels.min() >= 1 and labels.max() <= 2
    assert np.isfinite(sampled).all()
    # the ground truth is the test split's eval clouds, as the dataset's
    # get_batch gives them to the loader's batches of 4 (seed 0, the val
    # transform)
    config = evaluate_ae.eval_config(evaluate_ae.define_options_parser()
                                     .parse_args([workdir["exp"],
                                                  "smoke.ckpt", "test", "32",
                                                  "32", "autoencoding"]))
    dataset = evaluate_ae.build_dataset(config, "test")
    want = np.stack([s["eval_cloud"] for start in range(0, N_SHAPES, 4)
                     for s in dataset.get_batch(range(start, start + 4))])
    np.testing.assert_array_equal(gts, want)


def test_evaluate_reconstruction_without_svr(workdir):
    model, (res,) = _evaluate(workdir, "reconstruction", "--cd", "--f1")
    assert set(res) == {"cd", "f1_0.0010"}
    assert all(np.isfinite(v) for v in res.values())


def test_evaluate_restores_the_saved_model(workdir):
    model, _ = _evaluate(workdir, "autoencoding", "--cd", name="smoke.ckpt")
    saved = torch.load(os.path.join(_ckpt_dir(workdir["exp"], "smoke.ckpt"),
                                    "checkpoint.pt"), weights_only=True)
    got = model.state_dict()
    assert sorted(got) == sorted(saved["model_state"])
    for key, value in saved["model_state"].items():
        assert torch.equal(got[key], value), key


def test_evaluate_interpolation_raises(workdir):
    """Interpolation mode writes interpolations_<part>.h5 into the
    experiment (3 batches of 4 pairs, 5 steps); fewer than 2 steps exit
    as the JAX script does."""
    model, (arrays,) = _evaluate(workdir, "interpolation",
                                 "--interpolation_steps", "5")
    path = os.path.join(workdir["exp"], "interpolations_test.h5")
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["clouds1", "clouds2", "interpolations",
                             "labels"]
        got = {k: f[k][()] for k in f}
    assert got["clouds1"].shape == got["clouds2"].shape == (N_SHAPES, 3, 32)
    assert got["interpolations"].shape == (N_SHAPES, 3, 32, 5)
    assert got["labels"].shape == (N_SHAPES, 32, 5)
    assert got["interpolations"].dtype == np.float32
    assert got["labels"].dtype == np.uint8
    assert got["labels"].min() >= 1 and got["labels"].max() <= 2
    assert np.isfinite(got["interpolations"]).all()
    for key, value in arrays.items():
        np.testing.assert_array_equal(got[key], value.astype(got[key].dtype))
    with pytest.raises(SystemExit, match="interpolation_steps"):
        _evaluate(workdir, "interpolation", "--interpolation_steps", "1")


def test_reconstruct_ae_dump(workdir):
    samples, gts, labels = reconstruct_ae.main([
        workdir["exp"], "smoke.ckpt", "--batch_size", "3", "--device",
        "cpu"])
    for name, arr, shape in (("all_samples", samples, (N_SHAPES, 3, 32)),
                             ("all_gts", gts, (N_SHAPES, 3, 32)),
                             ("all_labels", labels, (N_SHAPES, 32))):
        assert arr.shape == shape
        np.testing.assert_array_equal(
            np.load(os.path.join(workdir["exp"], name + ".npy")), arr)
    assert np.isfinite(samples).all()
    assert labels.min() >= 1 and labels.max() <= 2


def test_train_svr_and_evaluate_reconstruction(workdir):
    d = workdir["dir"]
    state, timings = train_svr.main([str(d / "svr.yaml"), "svr", "1",
                                     "0.001", "--jobid", "s1", "--device",
                                     "cpu"])
    # 2 shapes x 24 views, batches of 16
    assert [t["steps"] for t in timings] == [3] and state.step == 3
    assert all(np.isfinite(v) for v in state.train_metrics.values())
    exp = str(d / "results" / "svr_s1")
    model, (res,) = evaluate_ae.main([
        exp, "svr.ckpt", "test", "32", "32", "reconstruction",
        "--batch_size", "20", "--cd", "--emd", "--f1",
        "--unit_scale_evaluation", "--save", "--device", "cpu"])
    assert set(res) == {"cd", "emd", "f1_0.0010"}
    assert all(np.isfinite(v) for v in res.values())
    with h5py.File(os.path.join(
            exp, "svr_test_32_32_clouds_reconstruction.h5"), "r") as f:
        assert f["image_clouds"].shape == (48, 4, 24, 24)
        assert f["sampled_clouds"].shape == (48, 3, 32)


@pytest.mark.parametrize("module,argv", [
    (train_ae, ["c.yaml", "m", "1", "0.001"]),
    (train_svr, ["c.yaml", "m", "1", "0.001"]),
    (evaluate_ae, ["exp", "m.ckpt", "test", "32", "32", "generating"]),
    (reconstruct_ae, ["exp", "m.ckpt"]),
    (import_torch_ckpt, ["ref.pkl", "c.yaml", "out"]),
])
def test_main_defaults_to_the_card(module, argv):
    """Without --device each command asks for the card: with none, it
    fails before it reads anything (the paths above do not exist)."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)


@pytest.mark.parametrize("flags", [["-n", "2"], ["--nodes", "2"]])
def test_multi_process_is_refused(tmp_path, flags):
    """train_svr refuses several nodes without --distributed, as train_ae
    does (the data-parallel run: tests/test_torch_port_distributed_svr.py)."""
    config = str(tmp_path / "svr.yaml")
    write_config(dict(SVR_CONFIG, path2data=str(tmp_path),
                      path2save=str(tmp_path / "results")), config)
    with pytest.raises(ValueError, match="needs --distributed"):
        train_svr.main([config, "m", "1", "0.001", *flags, "--device",
                        "cpu"])


@pytest.mark.parametrize("key", ["matmul_precision",
                                 "eval_matmul_precision"])
def test_precision_other_than_highest_is_refused(workdir, key):
    config = dict(load_config(os.path.join(workdir["exp"], "config.yaml")),
                  **{key: "high"})
    with pytest.raises(ValueError, match="highest"):
        train_ae.run(config, None, None, "cpu")
