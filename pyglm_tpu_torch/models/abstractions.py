"""Mixin contracts for distributions and models (PyTorch counterpart of
``pyglm_tpu/models/abstractions.py``, after ``pybasicbayes``'s
``Distribution``, ``GibbsSampling``, ``Model`` and
``ModelGibbsSampling``): the duck-typed interface every object of the
package follows, so that user code written against that object contract
ports directly."""
from __future__ import annotations

import abc


class Distribution(abc.ABC):
    """rvs() and log_likelihood()."""

    @abc.abstractmethod
    def rvs(self, *args, **kwargs):
        """Sample from the distribution."""

    @abc.abstractmethod
    def log_likelihood(self, x):
        """Log density or mass of data under the current parameters."""


class GibbsSampling(Distribution):
    """Adds resample(data): one draw from the conditional posterior."""

    @abc.abstractmethod
    def resample(self, data=None):
        ...


class Model(abc.ABC):
    @abc.abstractmethod
    def add_data(self, data):
        ...

    @abc.abstractmethod
    def generate(self, *args, **kwargs):
        ...


class ModelGibbsSampling(Model):
    @abc.abstractmethod
    def resample_model(self):
        ...
