"""Launch layer: device meshes (``launch.mesh``), the continuous-batching
server (``launch.serve``) and the trainer (``launch.train``). Import the
modules directly; importing this package touches no device."""
