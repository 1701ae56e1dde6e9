from eigenkernel_tpu_torch.core.types import EigenPairs, MatrixInfo, SparseMatrix

__all__ = ["EigenPairs", "MatrixInfo", "SparseMatrix"]
