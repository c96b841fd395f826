"""One rank of ``tests/test_torch_dp_train.py``'s 2-rank data-parallel run,
started by ``python -m deepspeed_tpu_torch.cli run`` (``DS_NUM_CHIPS=2``):
``python tests/torch_dp_rank.py --weights W.npz --out DIR``. It imports no
JAX. Each rank, on gloo:

1. trains the tiny Llama (:data:`LLAMA`, the weights of ``W.npz``) for 3
   steps at ZeRO stage 0, micro 2 x gas 2 x dp 2, AdamW, on the seeded
   global batches of :func:`batches`, each rank on its block;
2. trains the same 3 steps from the engine's dataloader over the same rows;
3. saves a checkpoint (rank 0 writes) and loads it into a new engine;
4. trains fp16 with an overflow planted in its own rows on rank 1 only;
5. trains the same 3 steps at ZeRO stage 1 (masters and moments
   partitioned over the two ranks).

It writes ``rank_<r>.json`` (losses, flags, errors) and ``rank_<r>.npz``
(the params after step 3 in the JAX layout) under ``DIR``."""

import argparse
import json
import os
import sys

import numpy as np

LLAMA = dict(vocab_size=256, max_seq=64, n_layer=2, n_head=4, n_kv_head=2, d_model=128, d_ff=256,
             pos_embedding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
             norm_eps=1e-6, attention_backend="flash")
MICRO, GAS, DP, STEPS, SEQ = 2, 2, 2, 3, 64
CONFIG = {"train_batch_size": MICRO * GAS * DP, "train_micro_batch_size_per_gpu": MICRO,
          "gradient_accumulation_steps": GAS,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 3e-4, "betas": [0.9, 0.95], "eps": 1e-8,
                                   "weight_decay": 0.1}},
          "scheduler": {"type": "WarmupLR",
                        "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 3e-4,
                                   "warmup_num_steps": 2}},
          "gradient_clipping": 1.0, "fused_cross_entropy": "off"}
FP16 = {"enabled": True, "initial_scale_power": 4, "loss_scale_window": 2, "hysteresis": 2}
OVERFLOW_STEP = 1          # the fp16 run's step whose rank-1 rows overflow


def batches(seed=1, n=STEPS):
    """The global batches: ``[gas * micro * dp, S]`` token ids."""
    r = np.random.default_rng(seed)
    return [{"input_ids": r.integers(0, LLAMA["vocab_size"], size=(GAS * MICRO * DP, SEQ))
             .astype(np.int32)} for _ in range(n)]


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _boost_loss(model):
    """The model's loss times the micro-batch's first ``boost`` row: a
    huge factor overflows the fp16 grads of the rank that is fed it."""
    def loss(params, batch, rng=None):
        return model.loss(params, {"input_ids": batch["input_ids"]}, rng) * batch["boost"][0]
    return loss


def _state_equal(a, b):
    import torch

    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import _flatten_tree, _state_tree
    fa, fb = _flatten_tree(_state_tree(a)), _flatten_tree(_state_tree(b))
    if fa.keys() != fb.keys():
        return False
    for k in fa:
        ta, tb = fa[k], fb[k]
        if hasattr(ta, "tensors"):
            if not all(torch.equal(x, y) for x, y in zip(ta.tensors, tb.tensors)):
                return False
        elif ta.snapshot().tolist() != tb.snapshot().tolist():
            return False
    return True


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

    torch.set_num_threads(1)
    with np.load(args.weights) as z:
        jparams = unflatten(dict(z))
    model = CausalLM(TransformerConfig(**LLAMA))

    def engine(config=CONFIG, loss=None, data=None):
        return deepspeed_tpu_torch.initialize(
            model=loss or model, model_parameters=params_from_jax(model.config, jparams),
            config=config, training_data=data, device="cpu")[0]

    rec = {}
    # 1. explicit global batches
    eng = engine()
    rank = dist.get_rank()
    rec.update(rank=rank, world=dist.get_world_size(), backend=torch.distributed.get_backend(),
               dp_rank=eng.dp_rank, dp_world=eng.dp_world_size,
               flat=eng._flat_grads is not None)
    rec["losses"] = [float(eng.train_batch(b)) for b in batches()]
    rec["lr"] = eng.get_lr()
    np.savez(os.path.join(args.out, f"rank_{rank}.npz"),
             **flatten(params_to_jax(model.config, eng.state.params)))

    # 2. the engine's dataloader over the same rows
    rows = [{"input_ids": row} for b in batches() for row in b["input_ids"]]
    loader_eng = engine(data=rows)
    rec["loader_losses"] = [float(loader_eng.train_batch()) for _ in range(STEPS)]
    rec["loader_state_equal"] = _state_equal(eng, loader_eng)
    del loader_eng

    # 3. a rank-0 checkpoint, loaded back on every rank
    ckpt = os.path.join(args.out, "ckpt")
    eng.save_checkpoint(ckpt)
    rec["ckpt_files"] = sorted(os.listdir(ckpt))
    fresh = engine()
    fresh.load_checkpoint(ckpt)
    rec["ckpt_state_equal"] = _state_equal(eng, fresh)
    del fresh

    # 4. fp16 with an overflow planted in rank 1's rows at OVERFLOW_STEP
    fp = engine(config={**CONFIG, "fp16": FP16, "scheduler": None}, loss=_boost_loss(model))
    rec["fp16"] = []
    for step, b in enumerate(batches(seed=9)):
        boost = np.ones((GAS, DP, MICRO), np.float32)
        if step == OVERFLOW_STEP:
            boost[:, 1] = 1e30
        before = [p.detach().clone() for p in fp.state.params.parameters()]
        fp.train_batch({**b, "boost": boost.reshape(-1)})
        same = all(torch.equal(a, p) for a, p in zip(before, fp.state.params.parameters()))
        rec["fp16"].append({"applied": fp.was_step_applied(), "unchanged": same,
                            "scale": fp.loss_scale, "good": fp.state.scaler.good_steps,
                            "hyst": fp.state.scaler.hysteresis})
    rec["fp16_skipped"] = fp.skipped_steps
    np.savez(os.path.join(args.out, f"fp16_rank_{rank}.npz"),
             **flatten(params_to_jax(model.config, fp.state.params)))

    # 5. ZeRO stage 1 over two ranks: the masters and moments partitioned
    st1 = engine(config={**CONFIG, "zero_optimization": {"stage": 1}})
    rec["stage1"] = [float(st1.train_batch(b)) for b in batches()]
    np.savez(os.path.join(args.out, f"stage1_rank_{rank}.npz"),
             **flatten(params_to_jax(model.config, st1.state.params)))
    del st1

    with open(os.path.join(args.out, f"rank_{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
