"""The port's kernels: the CUDA launch wrappers and their plain versions."""


def launch_counters() -> dict:
    """Every kernel wrapper by name; each adds one to its `.launches` where
    it launches its CUDA kernel, and nowhere else."""
    from . import gkr_init_cuda, init_cuda, round_cuda, transcript_cuda

    return {"round_nofold": round_cuda.round_nofold, "round_fold": round_cuda.round_fold,
            "round_step_nofold": round_cuda.round_step_nofold,
            "round_step_fold": round_cuda.round_step_fold,
            "round_fold_mxu": round_cuda.round_fold_mxu,
            "transcript_step": transcript_cuda.transcript_step,
            "pair_init": init_cuda.pair_init,
            "round_nofold_batched": round_cuda.round_nofold_batched,
            "round_fold_batched": round_cuda.round_fold_batched,
            "round_step_fold_batched": round_cuda.round_step_fold_batched,
            "transcript_step_batched": transcript_cuda.transcript_step_batched,
            "weight_reduce": gkr_init_cuda.weight_reduce,
            "weight_reduce_batched": gkr_init_cuda.weight_reduce_batched,
            "finish_sums": gkr_init_cuda.finish_sums,
            "pair_slots": gkr_init_cuda.pair_slots}
