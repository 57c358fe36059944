"""Pose estimation: EPnP RANSAC and pose-only Gauss-Newton."""
