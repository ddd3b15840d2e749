"""Point-cloud operators: gathers, KNN pyramid, matcher, pose solve."""
