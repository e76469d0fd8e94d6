from clipcap_tpu_torch.eval.base import run_eval

if __name__ == "__main__":
    exit(run_eval())
