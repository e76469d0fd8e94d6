from clipcap_tpu_torch.inference.demo import run_inference_demo

if __name__ == "__main__":
    exit(run_inference_demo())
