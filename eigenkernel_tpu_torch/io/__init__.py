from eigenkernel_tpu_torch.io.matrix_market import (
    MatrixMarketError,
    read_header,
    read_matrix,
    write_matrix,
)

__all__ = ["MatrixMarketError", "read_header", "read_matrix", "write_matrix"]
