from eigenkernel_tpu_torch.parallel.mesh import (
    DistMatrix,
    ProcessGrid,
    distribute,
    distribute_coo,
    gather,
    layout_grid,
    make_mesh,
    padded_dim,
    print_grid_mapping,
    single_device_mesh,
)

__all__ = [
    "DistMatrix",
    "ProcessGrid",
    "distribute",
    "distribute_coo",
    "gather",
    "layout_grid",
    "make_mesh",
    "padded_dim",
    "print_grid_mapping",
    "single_device_mesh",
]
