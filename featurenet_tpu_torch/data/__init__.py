"""Voxel data: STL parsing, voxelization, mesh emitters, the synthetic
part generator and its threaded input pipeline."""
