"""Geometry, plain back-projectors, filtering and planning primitives."""

from .geometry import (  # noqa: F401
    CTGeometry,
    projection_matrices,
    projection_matrix,
    standard_geometry,
)
from .baseline import backproject_rtk, bilinear_gather  # noqa: F401
from .backproject import (  # noqa: F401
    bp_share,
    bp_subline,
    bp_subline_batch,
    bp_subline_symmetry_batch,
    bp_symmetry,
    bp_transpose,
    transpose_projections,
    volume_to_native,
    volume_to_transposed,
)
from .tiling import (  # noqa: F401
    TileSpec,
    make_tiles,
    pad_projection_batch,
    pick_tile_shape,
    plan_proj_chunks,
    plan_z_slabs,
    plan_z_units,
    translate_matrices,
)
from .variants import (  # noqa: F401
    KernelSpec,
    REGISTRY,
    VARIANTS,
    get_spec,
    get_variant,
    slab_safe_variant,
)
from .fdk import fdk_reconstruct  # noqa: F401
from .phantom import ball_phantom, shepp_logan_3d  # noqa: F401
