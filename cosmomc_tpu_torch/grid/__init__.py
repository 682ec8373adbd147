"""Grid / batch orchestration (port of cosmomc_tpu/grid/; reference:
python/paramgrid/)."""

from cosmomc_tpu_torch.grid.batchjob import BatchJob, DataSet, JobItem, run_batch
from cosmomc_tpu_torch.grid.gridconfig import make_grid

__all__ = ["BatchJob", "DataSet", "JobItem", "run_batch", "make_grid"]
