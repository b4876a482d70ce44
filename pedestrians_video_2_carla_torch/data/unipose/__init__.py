"""Keypoints extracted by UniPoseLSTM (experimental, as in the JAX
package)."""
