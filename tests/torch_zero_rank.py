"""One rank of the ZeRO stage 1-3 tests (``tests/test_torch_zero*.py``),
started through the port's launcher on gloo:
``python tests/torch_zero_rank.py --mode MODE --weights W.npz --out DIR``.
It imports no JAX. Every mode trains the tiny Llama of
``tests/torch_dp_rank.py`` (:data:`LLAMA`, the weights of ``W.npz``) on the
seeded global batches of ``torch_dp_rank.batches`` and writes
``DIR/<mode>_rank_<r>.json`` (losses, held bytes, errors) and
``DIR/<mode>_<tag>_rank_<r>.npz`` (params in the JAX layout, gathered).

- ``dp2`` (2 ranks, ``{"dp": 2}``): stages 0-3 (stage 3 also with every
  unit partitioned, with and without remat), micro 2 x gas 2, AdamW, 3
  steps each; LAMB at stage 2
  with each group's trust ratio recorded, and again with the cross-rank sum
  of the LAMB partials left out; the health sentinels at stages 0 and 2
  (AdamW and LAMB); SGD, Lion and Adagrad at stages 0 and 2; LAMB with
  MoQ (stochastic rounding) at stages 0 and 2; bf16 with fp32
  accumulation at stages 0, 2 and 3; fp16 at stage 2 with an overflow
  planted in rank 1's rows; a callable client AdamW at stages 0 and 2;
  ``save_16bit_model`` at every stage; the engine's refusals under ZeRO.
- ``elastic_save`` (2 ranks): stage 2 for 3 steps, a checkpoint under
  ``--ckpt``, then the loss of one more step.
- ``fsdp`` (4 ranks, ``{"dp": 2, "fsdp": 2}``): stage 3 for 3 steps; the
  ``--ckpt`` checkpoint loaded at stage 3 and one step (micro 1 x gas 2);
  ``partition_axis`` "fsdp" refused.
- ``init`` (2 ranks): ``zero.Init`` against eager init, the peak of live
  layers while it streams, ``initialize`` at stage 3 with no params,
  ``GatheredParameters`` (a modification, read-only use), ``SparseTensor``
  and ``sparse_all_reduce``, ``mpu``.
"""

import argparse
import json
import os
import sys
import weakref

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests import torch_dp_rank as R  # noqa: E402

LLAMA = R.LLAMA
#: stage 3 of the dp2 mode with every unit partitioned (the tiny embedding
#: and head fall under the default persistence threshold)
ALL_PARTITIONED = {"stage3_param_persistence_threshold": 0}
LAMB_CONFIG = {**R.CONFIG, "optimizer": {"type": "Lamb",
                                         "params": {"lr": 1e-3, "betas": [0.9, 0.999],
                                                    "eps": 1e-6, "weight_decay": 0.01}}}
FSDP_MESH = {"dp": 2, "fsdp": 2}
#: the fsdp mode's batch: the same 8-row global batches over 4 ranks
FSDP_BATCH = {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 1,
               "gradient_accumulation_steps": 2}
ELASTIC_SEED = 7            # the batch of the step after the save
SPARSE = (16, 4, 3)         # vocab, row width, rows a rank
HEALTH = {"enabled": True, "window": 4, "warmup_steps": 2}
#: MoQ as the train_lamb cell runs it (symmetric, stochastic), at the tiny
#: size's group count and a schedule that reaches 8 bits in the 3 steps
MOQ_SR = {"enabled": True, "quantize_groups": 2,
          "quantize_bits": {"start_bits": 10, "target_bits": 8},
          "quantize_schedule": {"quantize_period": 1},
          "quantize_algo": {"q_type": "symmetric", "q_rounding": "stochastic"}}
BF16 = {"bf16": {"enabled": True}}
CLIENT_LR = 1e-4
SPARSE_SEED = 1


def zero_config(stage, base=None, **zero):
    cfg = dict(base or R.CONFIG)
    cfg["zero_optimization"] = {"stage": stage, **zero}
    return cfg


def sparse_inputs(world):
    """Each rank's token ids and grad rows, seeded (the JAX test's layout)."""
    vocab, D, n = SPARSE
    rng = np.random.default_rng(SPARSE_SEED)
    return (rng.integers(0, vocab, size=(world, n)).astype(np.int32),
            rng.normal(size=(world, n, D)).astype(np.float32))


class MPU:
    """A model-parallel unit (the reference's ``mpu`` contract)."""

    def __init__(self, dp, mp=1):
        self.dp, self.mp = dp, mp

    def get_data_parallel_world_size(self):
        return self.dp

    def get_model_parallel_world_size(self):
        return self.mp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True, choices=("dp2", "elastic_save", "fsdp", "init"))
    ap.add_argument("--weights", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args()
    import torch

    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.checkpoint.from_jax import params_from_jax, params_to_jax
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

    torch.set_num_threads(1)
    with np.load(args.weights) as z:
        jparams = R.unflatten(dict(z))
    model = CausalLM(TransformerConfig(**LLAMA))
    LLAMA_CFG = model.config

    def engine(config, params=True, model=model, **kw):
        return deepspeed_tpu_torch.initialize(
            model=model, config=config, device="cpu",
            model_parameters=params_from_jax(LLAMA_CFG, jparams) if params else None,
            **kw)[0]

    def save(eng, tag):
        """Every rank's gathered params after the run, in the JAX layout."""
        flat = R.flatten(params_to_jax(model.config, eng.gathered_params()))
        np.savez(os.path.join(args.out, f"{args.mode}_{tag}_rank_{dist.get_rank()}.npz"),
                 **flat)

    def refused(fn):
        try:
            fn()
        except NotImplementedError as e:
            return str(e)
        return None

    rec = {}
    rank = dist.get_rank() if dist.has_process_group() else None
    if args.mode == "dp2":
        runs = {"stage0": zero_config(0), "stage1": zero_config(1), "stage2": zero_config(2),
                "stage3": zero_config(3), "stage3_all": zero_config(3, **ALL_PARTITIONED)}
        no_remat = CausalLM(TransformerConfig(**{**LLAMA, "remat": False}))
        for tag, cfg in runs.items():
            eng = engine(cfg)
            rank = dist.get_rank()
            rec[tag] = {"losses": [float(eng.train_batch(b)) for b in R.batches()],
                        "held": eng.zero_held_bytes(), "world": dist.get_world_size(),
                        "describe": eng.zero_rules.describe()}
            if tag.startswith("stage3"):
                rec[tag]["peak_live_gathers"] = eng.state.params.peak_live_gathers
            save(eng, tag)
            # both ranks call it into one directory; rank 0 writes
            eng.save_16bit_model(args.out, f"model16_{tag}.npz")
            del eng
        # stage 3 without remat: the saved-tensor hooks gather each layer
        # again in the backward instead of keeping it from the forward
        eng = engine(zero_config(3, **ALL_PARTITIONED), model=no_remat)
        rec["stage3_noremat"] = {"losses": [float(eng.train_batch(b)) for b in R.batches()],
                                 "peak_live_gathers": eng.state.params.peak_live_gathers}
        save(eng, "stage3_noremat")
        del eng
        for tag, reduce in (("lamb", True), ("lamb_noreduce", False)):
            eng = engine(zero_config(2, LAMB_CONFIG))
            if not reduce:
                # each rank's own partials only: the planted fault
                eng._zero_reduce_partials = lambda p: p.sum(0, keepdim=True)
            ratios, step = [], []
            real = eng.tx.group_update

            def record(*a, **kw):
                r = real(*a, **kw)
                step.append(float(r))
                return r
            eng.tx.group_update = record
            losses = []
            for b in R.batches():
                step.clear()
                losses.append(float(eng.train_batch(b)))
                ratios.append(list(step))
            rec[tag] = {"losses": losses, "ratios": ratios,
                        "segments": {n: [s.lo, s.hi] for n, s in eng._zero._seg.items()}}
            save(eng, tag)
            del eng
        for tag, stage, base in (("health_stage0", 0, R.CONFIG), ("health_stage2", 2, R.CONFIG),
                                 ("health_lamb0", 0, LAMB_CONFIG),
                                 ("health_lamb2", 2, LAMB_CONFIG)):
            eng = engine(zero_config(stage, {**base, "telemetry": {"health": HEALTH}}))
            vectors = []
            for b in R.batches():
                eng.train_batch(b)
                vectors.append(eng._sentinels.tolist())
            rec[tag] = {"sentinels": vectors, "buckets": eng._health.bucket_names}
            eng.destroy()
            del eng
        # the elementwise optimizers on partitions, against their stage 0
        for name, params in (("SGD", {"momentum": 0.9}), ("Lion", {}), ("Adagrad", {})):
            for stage in (0, 2):
                cfg = zero_config(stage, {**R.CONFIG, "optimizer": {
                    "type": name, "params": {"lr": 1e-3, "weight_decay": 0.01, **params}}})
                eng = engine(cfg)
                rec[f"{name}_stage{stage}"] = [float(eng.train_batch(b)) for b in R.batches()]
                save(eng, f"{name}_stage{stage}")
                del eng
        # MoQ fake-quantizes the compute params, whole at stages 1-2
        for stage in (0, 2):
            eng = engine(zero_config(stage, {**LAMB_CONFIG, "quantize_training": MOQ_SR}))
            rec[f"moq_stage{stage}"] = [float(eng.train_batch(b)) for b in R.batches()]
            save(eng, f"moq_stage{stage}")
            del eng
        # bf16 compute, gas 2: every stage reduces the gradients in fp32
        for stage in (0, 2, 3):
            eng = engine(zero_config(stage, {**R.CONFIG, **BF16}, **ALL_PARTITIONED))
            rec[f"bf16_stage{stage}"] = [float(eng.train_batch(b)) for b in R.batches()]
            save(eng, f"bf16_stage{stage}")
            del eng
        # fp16 at stage 2: an overflow in rank 1's rows skips the step on both
        # ranks (the flag taken over each rank's own segments, then MAX-reduced)
        fp = engine(zero_config(2, {**R.CONFIG, "fp16": R.FP16, "scheduler": None}),
                    model=R._boost_loss(model))
        rec["fp16_stage2"] = []
        for step, b in enumerate(R.batches(seed=9)):
            boost = np.ones((R.GAS, R.DP, R.MICRO), np.float32)
            if step == R.OVERFLOW_STEP:
                boost[:, 1] = 1e30
            before = R.flatten(params_to_jax(model.config, fp.gathered_params()))
            fp.train_batch({**b, "boost": boost.reshape(-1)})
            after = R.flatten(params_to_jax(model.config, fp.gathered_params()))
            same = all(np.array_equal(before[k], after[k]) for k in before)
            rec["fp16_stage2"].append({"applied": fp.was_step_applied(), "unchanged": same,
                                       "scale": fp.loss_scale})
        del fp
        rec["refused"] = {
            "moq_stage3": refused(lambda: engine(zero_config(3, {
                **R.CONFIG, "quantize_training": {"enabled": True}}))),
            "client_built": refused(lambda: deepspeed_tpu_torch.initialize(
                model=model, model_parameters=params_from_jax(model.config, jparams),
                optimizer=torch.optim.SGD([torch.zeros(1)], lr=0.1),
                config=zero_config(1), device="cpu")),
        }
        for stage in (0, 2):
            client = engine(zero_config(stage),
                            optimizer=lambda ps: torch.optim.AdamW(ps, lr=CLIENT_LR))
            rec[f"client_stage{stage}"] = [float(client.train_batch(b)) for b in R.batches()]
            save(client, f"client_stage{stage}")
        rec["refused"]["client_state"] = refused(
            lambda: client.save_checkpoint(os.path.join(args.out, "client_ckpt")))
    elif args.mode == "elastic_save":
        eng = engine(zero_config(2))
        rank = dist.get_rank()
        rec["losses"] = [float(eng.train_batch(b)) for b in R.batches()]
        eng.save_checkpoint(args.ckpt, tag="elastic")
        save(eng, "saved")
        rec["global_steps"] = eng.global_steps
        rec["next_loss"] = float(eng.train_batch(R.batches(seed=ELASTIC_SEED, n=1)[0]))
    elif args.mode == "fsdp":
        mesh_cfg = {"mesh": FSDP_MESH}
        eng = engine({**zero_config(3), **mesh_cfg, **FSDP_BATCH})
        rank = dist.get_rank()
        rec["stage3"] = {"losses": [float(eng.train_batch(b)) for b in R.batches()],
                         "held": eng.zero_held_bytes(), "dp_rank": eng.dp_rank,
                         "describe": eng.zero_rules.describe(),
                         "axes": list(eng._zero.group)}
        save(eng, "stage3")
        del eng
        dst = engine({**zero_config(3), **mesh_cfg, **FSDP_BATCH})
        path, _ = dst.load_checkpoint(args.ckpt)
        rec["elastic"] = {"path": path, "global_steps": dst.global_steps}
        save(dst, "loaded")
        rec["elastic"]["next_loss"] = float(
            dst.train_batch(R.batches(seed=ELASTIC_SEED, n=1)[0]))
        del dst
        rec["refused"] = {"hybrid": refused(lambda: engine(
            {**zero_config(3, partition_axis="fsdp"), **mesh_cfg, **FSDP_BATCH}))}
    else:
        from deepspeed_tpu_torch.runtime import zero
        from deepspeed_tpu_torch.runtime.sparse_tensor import SparseTensor, sparse_all_reduce
        dist.init_distributed(dist_backend="gloo", verbose=False)
        rank, world = dist.get_rank(), dist.get_world_size()
        # zero.Init against eager init, and the live layers while it streams
        live, peak = [], [0]
        real_stream = zero.Init._stream

        def stream(self, key, subtree):
            peak[0] = max(peak[0], sum(1 for refs in live if any(r() is not None for r in refs)))
            live.append([weakref.ref(t) for d in subtree.values() for t in
                         (d.values() if isinstance(d, dict) else [d])])
            return real_stream(self, key, subtree)
        zero.Init._stream = stream
        with zero.Init(config={"stage3_param_persistence_threshold": 0}):
            part = model.init_params(torch.Generator().manual_seed(5))
        zero.Init._stream = real_stream
        eager = model.init_params(torch.Generator().manual_seed(5))
        full = part.to_dict()
        from deepspeed_tpu_torch.models.transformer import ParamTree
        got, want = dict(ParamTree(full).named_parameters()), dict(eager.named_parameters())
        rec["init"] = {"equal": got.keys() == want.keys() and all(
                           torch.equal(got[k], want[k]) for k in want),
                       "type": type(part).__name__, "streamed": len(live),
                       "peak_live_layers": peak[0],
                       "held": part.held_bytes(),
                       "full": sum(t.numel() * t.element_size() for t in want.values())}
        # GatheredParameters: every rank writes its own value, rank 0's wins
        before = {k: v.clone() for k, v in got.items()}
        gp = zero.GatheredParameters(part)
        with gp as mutable:
            mutable["embed"]["tokens"][:] = 7.0 + rank
        after = dict(ParamTree(part.to_dict()).named_parameters())
        rec["gathered"] = {
            "embed_min": float(after["embed.tokens"].min()),
            "embed_max": float(after["embed.tokens"].max()),
            "others_equal": all(torch.equal(after[k], before[k]) for k in before
                                if k != "embed.tokens")}
        with zero.GatheredParameters(part) as ro:
            _ = ro["ln_f"]["scale"].sum()
        again = dict(ParamTree(part.to_dict()).named_parameters())
        rec["gathered"]["readonly_equal"] = all(torch.equal(again[k], after[k]) for k in after)
        # the engine at stage 3 with no params: built under zero.Init
        eng = deepspeed_tpu_torch.initialize(model=model, config=zero_config(3, **ALL_PARTITIONED),
                                             device="cpu")[0]
        built = dict(eng.gathered_params().named_parameters())
        seeded = dict(model.init_params(torch.Generator().manual_seed(0)).named_parameters())
        rec["engine_init"] = {"type": type(eng.state.params).__name__,
                              "equal": all(torch.equal(built[k], seeded[k]) for k in seeded),
                              "loss": float(eng.train_batch(R.batches(n=1)[0]))}
        del eng
        # SparseTensor over the group
        ids, vals = sparse_inputs(world)
        st = SparseTensor.from_embedding_grad(torch.from_numpy(ids[rank]),
                                              torch.from_numpy(vals[rank]), SPARSE[0])
        red = sparse_all_reduce(st, "dp", average=True)
        rec["sparse"] = {"nnz": st.nnz, "reduced_nnz": red.nnz,
                         "dense": red.to_dense().tolist(), "local": st.to_dense().tolist(),
                         "coo_shape": list(red.to_coo_tensor()[2])}
        # mpu: the data-parallel world from it, a mismatch refused
        eng = engine(zero_config(1), mpu=MPU(world))
        rec["mpu"] = {"dp_world": eng.dp_world_size,
                      "config_world": eng._config.world_size}
        del eng
        try:
            engine(zero_config(1), mpu=MPU(world + 2))
            rec["mpu"]["mismatch"] = None
        except ValueError as e:
            rec["mpu"]["mismatch"] = str(e)
        rec["mpu"]["model_parallel"] = refused(lambda: engine(zero_config(1), mpu=MPU(world, 2)))
    with open(os.path.join(args.out, f"{args.mode}_rank_{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
