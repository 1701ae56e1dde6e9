from eigenkernel_tpu_torch.verify.verifier import (
    eval_orthogonality,
    eval_residual_norm,
    get_ipratios,
)

__all__ = ["eval_orthogonality", "eval_residual_norm", "get_ipratios"]
