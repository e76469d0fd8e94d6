from clipcap_tpu_torch.finetune import start_finetuning

if __name__ == "__main__":
    exit(start_finetuning())
