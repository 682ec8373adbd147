"""`python -m cosmomc_tpu_torch params.ini [key=value ...]`: the CLI entry
(driver.F90 analogue). Runs on the card; `device=cpu` asks for the CPU."""
from cosmomc_tpu_torch.driver import main

if __name__ == "__main__":
    raise SystemExit(main())
