"""Point-cloud operators: gathers, KNN pyramid, matcher, pose solve, and the
data layer's host voxel grid, radius matches and ICP."""
