"""Segmentation models: k-means, GMM, SLIC superpixels, spectral n-cut,
graph-merge min-cut, and the end-to-end pipeline composition."""

from gabor_color_image_segmentation.models.kmeans import kmeans, maximin_init

__all__ = ["kmeans", "maximin_init"]
