"""Declarative serving plans: inheritance, fail-closed validation, pattern
assignment, mixed-method application (reference analog:
``Optimize_ONNX_Common.py`` Plan/OptimizerConfig/resolve_plan/validate_plan)."""

import numpy as np
import pytest
import jax.numpy as jnp

from asr_jax.quant.plan import (
    OptimizerConfig, Plan, PlanError, apply_plans, plan_for_path, resolve_plan,
)
from asr_jax.quant.quantize import QuantizedLinear


def _cfg(**plans):
    return OptimizerConfig(plans={k: v for k, v in plans.items()})


def test_inheritance_and_defaults():
    cfg = OptimizerConfig(plans={
        "base": Plan(method="q8", block=64, refine_iters=1),
        "small": Plan(inherit="base", method="q4", pack=True),
    })
    rp = resolve_plan(cfg, "small")
    assert rp.method == "q4" and rp.block == 64 and rp.refine_iters == 1 and rp.pack
    base = resolve_plan(cfg, "base")
    assert base.method == "q8" and not base.pack


def test_fail_closed_validation():
    with pytest.raises(PlanError, match="unknown plan"):
        resolve_plan(OptimizerConfig(plans={}), "nope")
    cyc = OptimizerConfig(plans={"a": Plan(inherit="b"), "b": Plan(inherit="a")})
    with pytest.raises(PlanError, match="cycle"):
        resolve_plan(cyc, "a")
    with pytest.raises(PlanError, match="method"):
        resolve_plan(OptimizerConfig(plans={"p": Plan(method="int3")}), "p")
    with pytest.raises(PlanError, match="pack requires"):
        resolve_plan(OptimizerConfig(plans={"p": Plan(method="q8", pack=True)}), "p")
    with pytest.raises(PlanError, match="block"):
        resolve_plan(OptimizerConfig(plans={"p": Plan(method="q8", block=100)}), "p")


def test_pattern_assignment_first_match_wins():
    cfg = OptimizerConfig(
        plans={"enc": Plan(method="q4"), "default": Plan(method="bf16")},
        assign=(("encoder/*", "enc"), ("*", "default")),
    )
    assert plan_for_path(cfg, "encoder/blocks/0/w").method == "q4"
    assert plan_for_path(cfg, "decoder/blocks/0/w").method == "bf16"


def test_apply_plans_mixed_methods():
    rng = np.random.default_rng(0)
    params = {
        "encoder": {"blocks": [{"w": jnp.asarray(rng.standard_normal((128, 64)), jnp.float32),
                                "b": jnp.zeros((64,), jnp.float32)}]},
        "decoder": {"w": jnp.asarray(rng.standard_normal((128, 64)), jnp.float32)},
        "cmvn": {"mean": jnp.zeros((80,), jnp.float32)},
    }
    cfg = OptimizerConfig(
        plans={
            "enc_q": Plan(method="q8", block=64, min_size=1024, refine_iters=0),
            "half": Plan(method="bf16"),
            "keep": Plan(method="f32"),
        },
        assign=(("encoder/*", "enc_q"), ("decoder/*", "half"), ("*", "keep")),
    )
    out = apply_plans(params, cfg)
    assert isinstance(out["encoder"]["blocks"][0]["w"], QuantizedLinear)
    assert out["encoder"]["blocks"][0]["b"].dtype == jnp.float32  # weight-only
    assert out["decoder"]["w"].dtype == jnp.bfloat16
    assert out["cmvn"]["mean"].dtype == jnp.float32


def test_apply_plans_exclude_veto():
    rng = np.random.default_rng(1)
    params = {"a": {"w": jnp.asarray(rng.standard_normal((128, 64)), jnp.float32)},
              "b": {"w": jnp.asarray(rng.standard_normal((128, 64)), jnp.float32)}}
    cfg = OptimizerConfig(
        plans={"q": Plan(method="q8", min_size=1024, refine_iters=0, exclude=("a/*",))},
        assign=(("*", "q"),),
    )
    out = apply_plans(params, cfg)
    assert not isinstance(out["a"]["w"], QuantizedLinear)
    assert isinstance(out["b"]["w"], QuantizedLinear)


def test_config_json_roundtrip(tmp_path):
    cfg = OptimizerConfig(
        plans={"default": Plan(method="q4", pack=True, block=32),
               "head": Plan(inherit="default", method="q8", pack=False)},
        assign=(("joiner/*", "head"), ("*", "default")),
    )
    path = tmp_path / "plan.json"
    cfg.save(path)
    loaded = OptimizerConfig.load(path)
    assert resolve_plan(loaded, "head").method == "q8"
    assert resolve_plan(loaded, "default").pack
    assert loaded.assign == cfg.assign
    # invalid assignment target fails closed at apply time
    bad = OptimizerConfig(plans={}, assign=(("*", "ghost"),))
    with pytest.raises(PlanError):
        apply_plans({"w": jnp.zeros((8, 8))}, bad)


def test_apply_plans_skips_depthwise_and_quantizes_embeddings():
    """The dw/dw1/dw2 guard from quantize_pytree applies to plans too
    (depthwise kernels are consumed elementwise, not via dense()), and a
    plan with ``embeddings: true`` converts matching embed tables into
    gather-dequant QuantizedEmbedding leaves (the reference quantizes
    Decoder_Embed to Q8 as its own plan row,
    ``Fun_ASR_Nano/Optimize_ONNX.py:107-112``)."""
    from asr_jax.quant.quantize import QuantizedEmbedding

    rng = np.random.default_rng(2)
    arr = lambda shape: jnp.asarray(rng.standard_normal(shape), jnp.float32)
    params = {
        "enc": {"dw": {"w": arr((64, 64))},       # depthwise: must stay raw
                "fc": {"w": arr((128, 64))}},
        "embed": arr((256, 64)),
    }
    cfg = OptimizerConfig(
        plans={"q": Plan(method="q8", min_size=1024, refine_iters=0,
                         embeddings=True)},
        assign=(("*", "q"),),
    )
    out = apply_plans(params, cfg)
    assert isinstance(out["enc"]["dw"]["w"], jnp.ndarray)        # untouched
    assert isinstance(out["enc"]["fc"]["w"], QuantizedLinear)
    assert isinstance(out["embed"], QuantizedEmbedding)
    # embeddings default off: same plan without the flag leaves the table
    cfg_off = OptimizerConfig(
        plans={"q": Plan(method="q8", min_size=1024, refine_iters=0)},
        assign=(("*", "q"),),
    )
    assert isinstance(apply_plans(params, cfg_off)["embed"], jnp.ndarray)
