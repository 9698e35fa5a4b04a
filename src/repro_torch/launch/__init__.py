"""Launch layer: device meshes (``launch.mesh``) and the continuous-
batching server (``launch.serve``). Import the modules directly;
importing this package touches no device."""
