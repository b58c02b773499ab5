"""Plain float64 clip -> Adam -> cosine step on a flat parameter vector.

Clip by global norm (g * clip / |g| when |g| >= clip), Adam with bias
correction (b1 0.9, b2 0.999, eps 1e-8), learning rate from a cosine
schedule over the run's T epochs decaying to lr/10, stepped once per
epoch: lr_t = lr/10 + (lr - lr/10) (1 + cos(pi min(t, T) / T)) / 2.
"""

from __future__ import annotations

import math

import numpy as np


class Adam:
    def __init__(self, lr: float, epochs: int, clip: float = 10.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.T, self.clip = lr, epochs, clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.t = 0
        self.mu = self.nu = None

    def step(self, theta: np.ndarray, g: np.ndarray) -> np.ndarray:
        if self.mu is None:
            self.mu, self.nu = np.zeros_like(theta), np.zeros_like(theta)
        norm = float(np.sqrt((g * g).sum()))
        if norm >= self.clip:
            g = g / norm * self.clip
        eta_min = 0.1 * self.lr
        lr = eta_min + (self.lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * min(self.t, self.T) / self.T))
        self.mu = (1 - self.b1) * g + self.b1 * self.mu
        self.nu = (1 - self.b2) * g * g + self.b2 * self.nu
        self.t += 1
        step = (self.mu / (1 - self.b1 ** self.t)) / (
            np.sqrt(self.nu / (1 - self.b2 ** self.t)) + self.eps)
        return theta - lr * step
