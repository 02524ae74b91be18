"""Port parity: the tooling against the JAX package's, on the CPU.

``benchmarks.measure_bucketing_delta`` through both packages on one
resnet18's weights (equal mAPs, stress cosines within 1e-5);
``benchmarks.run_full_system_bench`` at a toy size (the JAX function's
keys, positive rates); ``utils.debug`` against ``jax_debug_nans`` /
``jax_debug_infs`` (a NaN or Inf in the forward pass and one that arises
only in the backward raise ``FloatingPointError`` in both) and
``assert_deterministic``; ``utils.metrics.profile_trace`` writing a
Chrome trace of a small extraction.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import irtpu.data.native as jnative
from irtpu.benchmarks import measure_bucketing_delta as jax_bucketing_delta
from irtpu.models.torch_port import port_retrieval_net
from irtpu.utils.debug import assert_deterministic as jax_assert_deterministic
from irtpu.utils.debug import debug_checks as jax_debug_checks

import image_retrieval_for_image_based_localization_tpu_torch as port
import image_retrieval_for_image_based_localization_tpu_torch.api as port_api
from image_retrieval_for_image_based_localization_tpu_torch.benchmarks import (
    measure_bucketing_delta,
    run_full_system_bench,
)
from image_retrieval_for_image_based_localization_tpu_torch.data import native as pnative
from image_retrieval_for_image_based_localization_tpu_torch.models import (
    RetrievalNet,
    init_random_,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.debug import (
    assert_deterministic,
    debug_checks,
)
from image_retrieval_for_image_based_localization_tpu_torch.utils.metrics import profile_trace
from torch_threads import one_thread  # noqa: F401  (a module fixture: torch's threads)


@pytest.fixture(scope="module")
def same_decoder():
    """Both packages decode path inputs with one host pipeline: the native
    library where both load theirs, else PIL in both (the JAX package's
    ``make`` writes its library in place, so a worker can lose the race
    to another worker's linker and keep to PIL; ROADMAP C12)."""
    with pytest.MonkeyPatch.context() as mp:
        if not (jnative.native_available() and pnative.native_available()):
            mp.setattr(jnative, "native_available", lambda: False)
            mp.setattr(port_api, "native_available", lambda: False)
        yield


def test_bucketing_delta_matches_jax(same_decoder, tmp_path):
    net = RetrievalNet("resnet18", "gem")
    init_random_(net, torch.Generator().manual_seed(0))
    sd = net.state_dict()
    got = measure_bucketing_delta(arch="resnet18", image_size=64, batch_size=4,
                                  synth_root=str(tmp_path / "port"), state_dict=sd,
                                  device="cpu")
    want = jax_bucketing_delta(arch="resnet18", image_size=64, batch_size=4,
                               synth_root=str(tmp_path / "jax"),
                               variables=port_retrieval_net(sd, "resnet18"))
    assert set(got) == set(want)
    for key in ("bucketed", "exact", "map_delta"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    for key in ("stress_cos_mean", "stress_cos_min"):
        assert got[key] == pytest.approx(want[key], abs=1e-5), key
    assert 0.0 < got["stress_cos_min"] <= got["stress_cos_mean"] <= 1.0 + 1e-6


def test_full_system_bench_small(tmp_path):
    """The JAX test's sizes (``tests/test_cli.py``): the JAX function's keys
    and positive rates, decode rates keyed by the resolved thread count."""
    res = run_full_system_bench(n_images=6, image_size=64, src_hw=(96, 128), arch="resnet18",
                                batch_size=3, nthreads_list=(1, 0), reps=2,
                                root=str(tmp_path), device="cpu")
    assert set(res) == {"n_images", "image_size", "jpeg_mb", "native", "decode_img_per_sec",
                        "device_img_per_sec", "e2e_img_per_sec", "overlap_efficiency"}
    assert (res["n_images"], res["image_size"]) == (6, 64)
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".jpg")]) == 6
    assert res["e2e_img_per_sec"] > 0 and res["device_img_per_sec"] > 0
    assert res["overlap_efficiency"] > 0
    if res["native"]:
        assert 1 <= len(res["decode_img_per_sec"]) <= 2
        assert "1" in res["decode_img_per_sec"]
        assert all(v > 0 for v in res["decode_img_per_sec"].values())
    else:
        assert res["decode_img_per_sec"] == {}


def _jax_grad_nan(x):
    return jax.grad(lambda v: (jnp.sqrt(v) * 0).sum())(x)


def _port_grad_nan(x):
    x = torch.as_tensor(np.asarray(x)).requires_grad_(True)
    (torch.sqrt(x) * 0).sum().backward()  # the forward is all zeros
    return x.grad


# (name, JAX function, port function, debug_checks kwargs): each raises
CASES = {
    "forward-nan": (lambda x: jax.jit(lambda v: v / v)(x).block_until_ready(),
                    lambda x: torch.as_tensor(np.asarray(x)) / torch.as_tensor(np.asarray(x)),
                    {}),
    "forward-inf": (lambda x: jax.jit(lambda v: 1.0 / v)(x).block_until_ready(),
                    lambda x: 1.0 / torch.as_tensor(np.asarray(x)), {"nans": False}),
    "backward-only-nan": (_jax_grad_nan, _port_grad_nan, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_debug_checks_raise_as_jax_does(case):
    jax_fn, port_fn, kw = CASES[case]
    x = np.zeros(4, np.float32)
    with pytest.raises(FloatingPointError):
        with jax_debug_checks(**kw):
            jax_fn(jnp.asarray(x))
    with pytest.raises(FloatingPointError):
        with debug_checks(**kw):
            port_fn(x)
    # off by default, and put back after the scope: no error
    port_fn(x)
    assert not torch.is_anomaly_enabled()


def test_debug_checks_pass_a_finite_extraction_and_skip_what_is_off():
    ex = port.Extractor(port.ExtractConfig(model=port.ModelConfig(arch="resnet18"),
                                           image_size=64, batch_size=2), device="cpu")
    images = [np.random.RandomState(i).rand(48, 64, 3).astype(np.float32) for i in range(3)]
    with debug_checks():
        d = ex.extract(images)
        torch.empty(1 << 16).fill_(1.0)[:3]  # unwritten memory is no result
    np.testing.assert_array_equal(d, ex.extract(images))
    with debug_checks(nans=False, infs=False):
        torch.zeros(2) / torch.zeros(2)


def test_assert_deterministic_catches_a_flaky_function_as_jax_does():
    ex = port.Extractor(port.ExtractConfig(model=port.ModelConfig(arch="resnet18"),
                                           image_size=64, batch_size=2), device="cpu")
    batch = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    assert_deterministic(ex, batch)
    assert_deterministic(lambda: {"d": torch.tensor([np.nan, 1.0], dtype=torch.bfloat16),
                                  "n": [np.arange(3), 7]})

    for check, arg in ((assert_deterministic, np.zeros(3)),
                       (jax_assert_deterministic, np.zeros(3))):
        calls = [0]

        def flaky(x):
            calls[0] += 1
            return x + calls[0]

        with pytest.raises(AssertionError, match=r"nondeterministic output \(max \|diff\|=1.0\)"):
            check(flaky, arg)
        with pytest.raises(AssertionError, match="nondeterministic"):
            calls[0] = 0
            check(flaky, arg, runs=3)


def test_profile_trace_writes_the_cpu_events_of_an_extraction(tmp_path):
    ex = port.Extractor(port.ExtractConfig(model=port.ModelConfig(arch="resnet18"),
                                           image_size=64, batch_size=2), device="cpu")
    images = [np.random.RandomState(i).rand(48, 64, 3).astype(np.float32) for i in range(2)]
    with profile_trace(str(tmp_path / "trace")) as prof:
        ex.extract(images)
    names = {e.name for e in prof.events()}
    assert "aten::convolution" in names or "aten::conv2d" in names
    files = os.listdir(tmp_path / "trace")
    assert [os.path.join(tmp_path / "trace", f) for f in files] == [prof.trace_path]
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") in ("aten::conv2d", "aten::convolution") for e in events)

    with profile_trace(str(tmp_path / "off"), enabled=False) as off:
        ex.extract(images)
    assert off is None and not os.path.exists(tmp_path / "off")
