from loongx_tpu_torch.evaluation.metrics import (  # noqa: F401
    eval_distance,
    cosine_matrix_mean,
    pair_generated_gt,
    evaluate_directory,
)
