from clipcap_tpu_torch.init import init

if __name__ == "__main__":
    exit(init())
