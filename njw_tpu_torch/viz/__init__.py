"""Visualisation: counterpart of ``njw_tpu.viz``.

Every view of the JAX package (weather, particles, medical imaging, and
the ``geospatial`` and ``geofinancial`` submodules) with the same
signature. Each takes NumPy arrays or tensors on any device and of any
dtype (``_common.to_numpy``). matplotlib is imported, on the Agg
backend, only when a view draws (``_common.pyplot``): this package
imports without it, and a view that would draw then raises an
ImportError naming matplotlib. The two ``generate_*_report`` functions
write their HTML tables without images instead.
"""
from njw_tpu_torch.viz.weather import (
    visualize_field, visualize_velocity, visualize_vorticity,
    visualize_height, animate_simulation, plot_performance,
)
from njw_tpu_torch.viz.particles import (
    plot_particles_3d, plot_energy_history, plot_trajectory,
    plot_temperature,
)
from njw_tpu_torch.viz.imaging import (
    show_image, show_sinogram, compare_images, create_medical_colormap,
    plot_overlay, plot_slice, plot_orthogonal_slices,
    create_volume_animation, plot_histogram, plot_surface_3d,
    plot_difference, plot_image, plot_images, plot_comparison,
    plot_ct_projection,
)
