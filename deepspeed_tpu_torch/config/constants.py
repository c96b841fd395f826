"""Config key names and defaults that the training slice reads (the subset
of ``deepspeed_tpu/config/constants.py`` it needs, same names and values)."""

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer and lr scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"

#############################################
# Steps, timers
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

#############################################
# bf16 / fp16 / amp
#############################################
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # keeping for backwards compatibility
FP16 = "fp16"
AMP = "amp"

#############################################
# Gradient clipping
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

#############################################
# Data types
#############################################
DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"
GRAD_ACCUM_DTYPE_DEFAULT = None

#############################################
# ZeRO
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_STAGE = "stage"
ZERO_STAGE_DEFAULT = 0

#############################################
# Vocab-head loss kernel: overrides the model config's fused_cross_entropy
# ("auto"|"on"|"off") when set
#############################################
FUSED_CROSS_ENTROPY = "fused_cross_entropy"
FUSED_CROSS_ENTROPY_DEFAULT = None

#############################################
# Sparse attention (kept, read by nothing: the model's sparsity config decides)
#############################################
SPARSE_ATTENTION = "sparse_attention"

#############################################
# Elasticity (elasticity/config.py, elasticity/elasticity.py)
#############################################
ELASTICITY = "elasticity"
ENABLED = "enabled"
ENABLED_DEFAULT = False
MAX_ACCEPTABLE_BATCH_SIZE = "max_train_batch_size"
MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT = 2000
MICRO_BATCHES = "micro_batch_sizes"
MICRO_BATCHES_DEFAULT = [2, 4, 6]
MIN_GPUS = "min_gpus"
MIN_GPUS_DEFAULT = 1
MAX_GPUS = "max_gpus"
MAX_GPUS_DEFAULT = 10000
MIN_TIME = "min_time"
MIN_TIME_DEFAULT = 0
VERSION = "version"
LATEST_ELASTICITY_VERSION = 0.2
ELASTICITY_DEFAULT_VERSION = 0.2
PREFER_LARGER_BATCH = "prefer_larger_batch"
PREFER_LARGER_BATCH_DEFAULT = True
IGNORE_NON_ELASTIC_BATCH_INFO = "ignore_non_elastic_batch_info"
IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT = False
MODEL_PARALLEL_SIZE = "model_parallel_size"
MODEL_PARALLEL_SIZE_DEFAULT = 1
NUM_GPUS_PER_NODE = "num_gpus_per_node"
NUM_GPUS_PER_NODE_DEFAULT = 1

MESH = "mesh"
MESH_AXES_DEFAULT = {"dp": -1}
