// Native embedded KV store for the hot/cold beacon DB.
//
// The reference links LevelDB (C++) for the beacon store and LMDB/MDBX (C)
// for the slasher (beacon_node/store/src/leveldb_store.rs,
// slasher/src/database/) — native embedded storage engines, not Python.
// This is the TPU build's native equivalent: an own-design log-structured
// merge store, written from scratch for this workload (few very large
// values = serialized BeaconStates, many small values = roots/summaries,
// whole-column prefix scans for iteration, atomic multi-op batches for
// fork-choice/head consistency).
//
// Design:
//   * WAL  ("wal.log"): append-only batch records
//         [u32 crc32c(payload)] [u32 payload_len] [payload]
//     where payload = u32 op_count, then per op:
//         [u8 type] [u32 klen] [u32 vlen] [key] [value]
//     (type 0 = put, 1 = delete). One batch record == one atomic commit:
//     replay stops at the first bad/truncated record, so a torn batch is
//     invisible after a crash.
//   * Memtable: std::map<key, optional<value>> (nullopt = tombstone).
//   * SSTables ("sst-%06u.tbl"): written on flush, sorted, immutable:
//         entries..., index, footer
//     The full index (key -> value offset/len/type) is loaded at open;
//     point reads pread() only the value bytes. Newer tables shadow older.
//   * Compaction: merging all tables into one when the table count grows;
//     full merges drop tombstones.
//
// C ABI at the bottom; Python binds with ctypes (store/native.py).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <string>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/file.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------- crc32c
uint32_t crc32c_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      crc32c_table[i] = c;
    }
  }
} crc_init;

uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    c = crc32c_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------- helpers
void put_u32(std::string& out, uint32_t v) {
  out.append(reinterpret_cast<const char*>(&v), 4);
}
void put_u64(std::string& out, uint64_t v) {
  out.append(reinterpret_cast<const char*>(&v), 8);
}
uint32_t get_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint64_t get_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// Durability helper: fsync a directory so renames/creates inside it are
// on disk (a renamed sstable is not durable until its dir entry is).
bool fsync_dir(const std::string& dir) {
  int fd = ::open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (fd < 0) return false;
  bool ok = fsync(fd) == 0;
  ::close(fd);
  return ok;
}

constexpr uint32_t kSstMagic = 0x4C53544Du;  // "LSTM"
constexpr uint8_t kOpPut = 0;
constexpr uint8_t kOpDelete = 1;

struct Op {
  uint8_t type;
  std::string key;
  std::string value;
};

// Parse a WAL/batch payload. Returns false on malformed input.
bool parse_payload(const uint8_t* p, size_t n, std::vector<Op>* out) {
  if (n < 4) return false;
  uint32_t count = get_u32(p);
  size_t pos = 4;
  out->clear();
  out->reserve(count);
  for (uint32_t i = 0; i < count; i++) {
    if (pos + 9 > n) return false;
    Op op;
    op.type = p[pos];
    uint32_t klen = get_u32(p + pos + 1);
    uint32_t vlen = get_u32(p + pos + 5);
    pos += 9;
    if (op.type > kOpDelete) return false;
    if (pos + klen + vlen > n) return false;
    op.key.assign(reinterpret_cast<const char*>(p + pos), klen);
    pos += klen;
    op.value.assign(reinterpret_cast<const char*>(p + pos), vlen);
    pos += vlen;
    out->push_back(std::move(op));
  }
  return pos == n;
}

// ---------------------------------------------------------------- sstable
struct IndexEntry {
  uint64_t voff;
  uint32_t vlen;
  uint8_t type;
};

class SsTable {
 public:
  // Write a sorted run to `path`. `items` maps key -> (value or tombstone).
  static bool write(const std::string& path,
                    const std::map<std::string, std::optional<std::string>>& items,
                    std::string* err) {
    std::string tmp = path + ".tmp";
    FILE* f = std::fopen(tmp.c_str(), "wb");
    if (!f) {
      *err = "open " + tmp + ": " + std::strerror(errno);
      return false;
    }
    std::string index;
    uint64_t off = 0;
    uint32_t count = 0;
    bool ok = true;
    for (const auto& [key, val] : items) {
      uint8_t type = val ? kOpPut : kOpDelete;
      uint32_t vlen = val ? static_cast<uint32_t>(val->size()) : 0;
      // entry: [u8 type][u32 klen][u32 vlen][key][value]
      std::string hdr;
      hdr.push_back(static_cast<char>(type));
      put_u32(hdr, static_cast<uint32_t>(key.size()));
      put_u32(hdr, vlen);
      ok = ok && std::fwrite(hdr.data(), 1, hdr.size(), f) == hdr.size();
      ok = ok && std::fwrite(key.data(), 1, key.size(), f) == key.size();
      if (val)
        ok = ok && std::fwrite(val->data(), 1, vlen, f) == vlen;
      // index row: [u32 klen][key][u64 voff][u32 vlen][u8 type]
      put_u32(index, static_cast<uint32_t>(key.size()));
      index.append(key);
      uint64_t voff = off + hdr.size() + key.size();
      put_u64(index, voff);
      put_u32(index, vlen);
      index.push_back(static_cast<char>(type));
      off += hdr.size() + key.size() + vlen;
      count++;
      if (!ok) break;
    }
    uint64_t index_off = off;
    std::string footer;
    put_u64(footer, index_off);
    put_u32(footer, count);
    put_u32(footer, crc32c(reinterpret_cast<const uint8_t*>(index.data()),
                           index.size()));
    put_u32(footer, kSstMagic);
    ok = ok && std::fwrite(index.data(), 1, index.size(), f) == index.size();
    ok = ok && std::fwrite(footer.data(), 1, footer.size(), f) == footer.size();
    ok = ok && std::fflush(f) == 0 && fsync(fileno(f)) == 0;
    std::fclose(f);
    if (!ok) {
      *err = "write " + tmp + " failed";
      std::remove(tmp.c_str());
      return false;
    }
    if (std::rename(tmp.c_str(), path.c_str()) != 0) {
      *err = "rename " + tmp + ": " + std::strerror(errno);
      std::remove(tmp.c_str());
      return false;
    }
    // the rename is durable only once the directory entry is synced —
    // callers truncate the WAL right after, so this must not be skipped
    std::string dir = path.substr(0, path.find_last_of('/'));
    if (!fsync_dir(dir.empty() ? "." : dir)) {
      *err = "fsync dir of " + path + " failed";
      return false;
    }
    return true;
  }

  // Open and load the index. Returns nullptr (with *err) on corruption.
  static std::unique_ptr<SsTable> open(const std::string& path,
                                       std::string* err) {
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) {
      *err = "open " + path + ": " + std::strerror(errno);
      return nullptr;
    }
    auto t = std::unique_ptr<SsTable>(new SsTable());
    t->fd_ = fd;
    t->path_ = path;
    off_t size = lseek(fd, 0, SEEK_END);
    if (size < 20) {
      *err = "sstable too small: " + path;
      return nullptr;
    }
    uint8_t footer[20];
    if (pread(fd, footer, 20, size - 20) != 20) {
      *err = "footer read failed: " + path;
      return nullptr;
    }
    if (get_u32(footer + 16) != kSstMagic) {
      *err = "bad magic: " + path;
      return nullptr;
    }
    uint64_t index_off = get_u64(footer);
    uint32_t count = get_u32(footer + 8);
    uint32_t index_crc = get_u32(footer + 12);
    if (index_off > static_cast<uint64_t>(size) - 20) {
      *err = "bad index offset: " + path;
      return nullptr;
    }
    size_t index_len = size - 20 - index_off;
    std::vector<uint8_t> index(index_len);
    if (index_len &&
        pread(fd, index.data(), index_len, index_off) !=
            static_cast<ssize_t>(index_len)) {
      *err = "index read failed: " + path;
      return nullptr;
    }
    if (crc32c(index.data(), index_len) != index_crc) {
      *err = "index crc mismatch: " + path;
      return nullptr;
    }
    size_t pos = 0;
    for (uint32_t i = 0; i < count; i++) {
      if (pos + 4 > index_len) {
        *err = "index truncated: " + path;
        return nullptr;
      }
      uint32_t klen = get_u32(index.data() + pos);
      pos += 4;
      if (pos + klen + 13 > index_len) {
        *err = "index truncated: " + path;
        return nullptr;
      }
      std::string key(reinterpret_cast<const char*>(index.data() + pos), klen);
      pos += klen;
      IndexEntry e;
      e.voff = get_u64(index.data() + pos);
      e.vlen = get_u32(index.data() + pos + 8);
      e.type = index[pos + 12];
      pos += 13;
      t->keys_.push_back(std::move(key));
      t->entries_.push_back(e);
    }
    return t;
  }

  ~SsTable() {
    if (fd_ >= 0) ::close(fd_);
  }

  // Point lookup. Returns: 0 = found (value in *out), 1 = tombstone,
  // 2 = absent, -1 = IO error. `limit` < 0 reads the whole value.
  int get(const std::string& key, int64_t limit, std::string* out) const {
    auto it = std::lower_bound(keys_.begin(), keys_.end(), key);
    if (it == keys_.end() || *it != key) return 2;
    const IndexEntry& e = entries_[it - keys_.begin()];
    if (e.type == kOpDelete) return 1;
    uint32_t want = e.vlen;
    if (limit >= 0 && static_cast<uint64_t>(limit) < want)
      want = static_cast<uint32_t>(limit);
    out->resize(want);
    if (want && pread(fd_, out->data(), want, e.voff) !=
                    static_cast<ssize_t>(want))
      return -1;
    return 0;
  }

  const std::vector<std::string>& keys() const { return keys_; }
  const std::vector<IndexEntry>& entries() const { return entries_; }
  const std::string& path() const { return path_; }

  // Full entry read (for compaction).
  int read_value(size_t i, std::string* out) const {
    const IndexEntry& e = entries_[i];
    out->resize(e.vlen);
    if (e.vlen && pread(fd_, out->data(), e.vlen, e.voff) !=
                      static_cast<ssize_t>(e.vlen))
      return -1;
    return 0;
  }

 private:
  SsTable() = default;
  int fd_ = -1;
  std::string path_;
  std::vector<std::string> keys_;       // sorted
  std::vector<IndexEntry> entries_;     // parallel to keys_
};

// ---------------------------------------------------------------- the db
class LsmDb {
 public:
  static LsmDb* open(const std::string& dir, std::string* err) {
    auto db = std::make_unique<LsmDb>();
    db->dir_ = dir;
    if (mkdir(dir.c_str(), 0755) != 0 && errno != EEXIST) {
      *err = "mkdir " + dir + ": " + std::strerror(errno);
      return nullptr;
    }
    // Single-writer lock (LevelDB's LOCK file): a second opener — e.g. a
    // database-manager CLI against a running node — must fail loudly
    // instead of truncating the live WAL / colliding sstable names.
    db->lock_fd_ = ::open((dir + "/LOCK").c_str(), O_WRONLY | O_CREAT, 0644);
    if (db->lock_fd_ < 0) {
      *err = "open LOCK: " + std::string(std::strerror(errno));
      return nullptr;
    }
    if (flock(db->lock_fd_, LOCK_EX | LOCK_NB) != 0) {
      *err = "store at " + dir + " is locked by another process";
      return nullptr;
    }
    // Load SSTables in numeric order (oldest first).
    std::vector<std::pair<unsigned, std::string>> ssts;
    DIR* d = opendir(dir.c_str());
    if (!d) {
      *err = "opendir " + dir + ": " + std::strerror(errno);
      return nullptr;
    }
    while (dirent* ent = readdir(d)) {
      unsigned n;
      if (std::sscanf(ent->d_name, "sst-%06u.tbl", &n) == 1)
        ssts.emplace_back(n, dir + "/" + ent->d_name);
    }
    closedir(d);
    std::sort(ssts.begin(), ssts.end());
    for (const auto& [n, path] : ssts) {
      auto t = SsTable::open(path, err);
      if (!t) return nullptr;
      db->tables_.push_back(std::move(t));
      db->next_sst_ = std::max(db->next_sst_, n + 1);
    }
    if (!db->replay_wal(err)) return nullptr;
    if (!db->open_wal_for_append(err)) return nullptr;
    return db.release();
  }

  ~LsmDb() {
    if (!abandoned_) {
      std::string err;
      flush(&err);  // best effort
    }
    if (wal_fd_ >= 0) ::close(wal_fd_);
    if (lock_fd_ >= 0) ::close(lock_fd_);  // releases the flock
  }

  // Crash simulation (tests): drop every handle WITHOUT flushing, so a
  // reopen sees exactly what a power loss would have left on disk.
  void abandon() {
    std::lock_guard<std::mutex> g(mu_);
    abandoned_ = true;
  }

  int get(const std::string& key, int64_t limit, std::string* out) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = mem_.find(key);
    if (it != mem_.end()) {
      if (!it->second) return 1;  // tombstone
      const std::string& v = *it->second;
      if (limit >= 0 && static_cast<uint64_t>(limit) < v.size())
        out->assign(v.data(), limit);
      else
        *out = v;
      return 0;
    }
    for (auto t = tables_.rbegin(); t != tables_.rend(); ++t) {
      int r = (*t)->get(key, limit, out);
      if (r != 2) return r == 0 ? 0 : (r == 1 ? 1 : -1);
    }
    return 2;
  }

  int write_batch(const std::vector<Op>& ops, std::string* err) {
    std::lock_guard<std::mutex> g(mu_);
    // WAL record first.
    std::string payload;
    put_u32(payload, static_cast<uint32_t>(ops.size()));
    for (const Op& op : ops) {
      payload.push_back(static_cast<char>(op.type));
      put_u32(payload, static_cast<uint32_t>(op.key.size()));
      put_u32(payload,
              op.type == kOpPut ? static_cast<uint32_t>(op.value.size()) : 0);
      payload.append(op.key);
      if (op.type == kOpPut) payload.append(op.value);
    }
    std::string rec;
    put_u32(rec, crc32c(reinterpret_cast<const uint8_t*>(payload.data()),
                        payload.size()));
    put_u32(rec, static_cast<uint32_t>(payload.size()));
    rec.append(payload);
    if (::write(wal_fd_, rec.data(), rec.size()) !=
        static_cast<ssize_t>(rec.size())) {
      *err = std::string("wal write: ") + std::strerror(errno);
      return -1;
    }
    // a batch is acknowledged only once it is ON DISK — block import and
    // slasher history both rely on committed batches surviving power loss
    if (fdatasync(wal_fd_) != 0) {
      *err = std::string("wal fdatasync: ") + std::strerror(errno);
      return -1;
    }
    wal_bytes_ += rec.size();
    // Apply to memtable.
    for (const Op& op : ops) {
      if (op.type == kOpPut) {
        mem_bytes_ += op.key.size() + op.value.size();
        mem_[op.key] = op.value;
      } else {
        mem_bytes_ += op.key.size();
        mem_[op.key] = std::nullopt;
      }
    }
    if (mem_bytes_ >= mem_limit_) {
      if (!flush_locked(err)) return -1;
      if (tables_.size() >= compact_trigger_ && !compact_locked(err))
        return -1;
    }
    return 0;
  }

  bool flush(std::string* err) {
    std::lock_guard<std::mutex> g(mu_);
    return flush_locked(err);
  }

  bool compact(std::string* err) {
    std::lock_guard<std::mutex> g(mu_);
    if (!flush_locked(err)) return false;
    return compact_locked(err);
  }

  // Concatenated [u32 klen][key] for every live key starting with prefix.
  bool scan_prefix(const std::string& prefix, std::string* out) {
    std::lock_guard<std::mutex> g(mu_);
    // Merge all sources newest-first; first hit per key wins.
    std::map<std::string, bool> live;  // key -> is_put
    auto upper = [&](const std::string& k) {
      return !prefix.empty() &&
             (k.size() < prefix.size() ||
              std::memcmp(k.data(), prefix.data(), prefix.size()) != 0);
    };
    for (const auto& t : tables_) {
      const auto& keys = t->keys();
      auto it = std::lower_bound(keys.begin(), keys.end(), prefix);
      for (; it != keys.end() && !upper(*it); ++it) {
        size_t i = it - keys.begin();
        live[*it] = t->entries()[i].type == kOpPut;  // later tables override
      }
    }
    for (auto it = mem_.lower_bound(prefix); it != mem_.end() && !upper(it->first);
         ++it)
      live[it->first] = it->second.has_value();
    out->clear();
    for (const auto& [k, is_put] : live) {
      if (!is_put) continue;
      put_u32(*out, static_cast<uint32_t>(k.size()));
      out->append(k);
    }
    return true;
  }

  uint64_t stat(int what) {
    std::lock_guard<std::mutex> g(mu_);
    switch (what) {
      case 0: return tables_.size();
      case 1: return mem_.size();
      case 2: return mem_bytes_;
      case 3: return wal_bytes_;
      default: return 0;
    }
  }

  void set_mem_limit(uint64_t bytes) {
    std::lock_guard<std::mutex> g(mu_);
    mem_limit_ = bytes;
  }

 private:
  std::string wal_path() const { return dir_ + "/wal.log"; }

  bool replay_wal(std::string* err) {
    FILE* f = std::fopen(wal_path().c_str(), "rb");
    if (!f) return true;  // no WAL yet
    std::vector<uint8_t> buf;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf.resize(size);
    if (size && std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
      std::fclose(f);
      *err = "wal read failed";
      return false;
    }
    std::fclose(f);
    size_t pos = 0;
    std::vector<Op> ops;
    while (pos + 8 <= buf.size()) {
      uint32_t crc = get_u32(buf.data() + pos);
      uint32_t len = get_u32(buf.data() + pos + 4);
      if (pos + 8 + len > buf.size()) break;  // torn tail
      const uint8_t* payload = buf.data() + pos + 8;
      if (crc32c(payload, len) != crc) break;  // corrupt tail — stop
      if (!parse_payload(payload, len, &ops)) break;
      for (const Op& op : ops) {
        if (op.type == kOpPut) {
          mem_bytes_ += op.key.size() + op.value.size();
          mem_[op.key] = op.value;
        } else {
          mem_bytes_ += op.key.size();
          mem_[op.key] = std::nullopt;
        }
      }
      pos += 8 + len;
    }
    wal_bytes_ = pos;
    return true;
  }

  bool open_wal_for_append(std::string* err) {
    // Truncate past any torn tail found during replay, then append.
    wal_fd_ = ::open(wal_path().c_str(), O_WRONLY | O_CREAT, 0644);
    if (wal_fd_ < 0) {
      *err = std::string("wal open: ") + std::strerror(errno);
      return false;
    }
    if (ftruncate(wal_fd_, wal_bytes_) != 0 ||
        lseek(wal_fd_, wal_bytes_, SEEK_SET) < 0) {
      *err = std::string("wal truncate: ") + std::strerror(errno);
      return false;
    }
    return true;
  }

  bool flush_locked(std::string* err) {
    if (mem_.empty()) return true;
    char name[32];
    std::snprintf(name, sizeof(name), "sst-%06u.tbl", next_sst_);
    std::string path = dir_ + "/" + name;
    if (!SsTable::write(path, mem_, err)) return false;
    auto t = SsTable::open(path, err);
    if (!t) return false;
    next_sst_++;
    tables_.push_back(std::move(t));
    mem_.clear();
    mem_bytes_ = 0;
    // WAL content is now durable in the SSTable — reset it.
    if (ftruncate(wal_fd_, 0) != 0 || lseek(wal_fd_, 0, SEEK_SET) < 0) {
      *err = std::string("wal reset: ") + std::strerror(errno);
      return false;
    }
    wal_bytes_ = 0;
    return true;
  }

  bool compact_locked(std::string* err) {
    if (tables_.size() <= 1) return true;
    // Newest-wins merge of every table; full merge drops tombstones.
    std::map<std::string, std::optional<std::string>> merged;
    for (const auto& t : tables_) {  // oldest -> newest so newest overwrites
      const auto& keys = t->keys();
      for (size_t i = 0; i < keys.size(); i++) {
        if (t->entries()[i].type == kOpDelete) {
          merged[keys[i]] = std::nullopt;
        } else {
          std::string v;
          if (t->read_value(i, &v) != 0) {
            *err = "compaction read failed: " + t->path();
            return false;
          }
          merged[keys[i]] = std::move(v);
        }
      }
    }
    for (auto it = merged.begin(); it != merged.end();)
      it = it->second ? std::next(it) : merged.erase(it);
    char name[32];
    std::snprintf(name, sizeof(name), "sst-%06u.tbl", next_sst_);
    std::string path = dir_ + "/" + name;
    if (!SsTable::write(path, merged, err)) return false;
    auto nt = SsTable::open(path, err);
    if (!nt) return false;
    next_sst_++;
    std::vector<std::string> old_paths;
    for (const auto& t : tables_) old_paths.push_back(t->path());
    tables_.clear();
    tables_.push_back(std::move(nt));
    for (const auto& p : old_paths) std::remove(p.c_str());
    return true;
  }

  std::string dir_;
  std::mutex mu_;
  std::map<std::string, std::optional<std::string>> mem_;
  uint64_t mem_bytes_ = 0;
  uint64_t mem_limit_ = 64ull << 20;  // states are MB-scale; flush at 64 MiB
  uint64_t wal_bytes_ = 0;
  int wal_fd_ = -1;
  int lock_fd_ = -1;
  bool abandoned_ = false;
  unsigned next_sst_ = 0;
  size_t compact_trigger_ = 8;
  std::vector<std::unique_ptr<SsTable>> tables_;
};

thread_local std::string g_err;

void set_err(const std::string& e, char** err_out) {
  g_err = e;
  if (err_out) *err_out = const_cast<char*>(g_err.c_str());
}

}  // namespace

// ---------------------------------------------------------------- C ABI
extern "C" {

void* lsm_open(const char* dir, char** err) {
  std::string e;
  LsmDb* db = LsmDb::open(dir, &e);
  if (!db) set_err(e, err);
  return db;
}

void lsm_close(void* db) { delete static_cast<LsmDb*>(db); }

// Close WITHOUT flushing (crash simulation in tests).
void lsm_abandon(void* db) {
  LsmDb* p = static_cast<LsmDb*>(db);
  p->abandon();
  delete p;
}

// Returns 0 found, 1 absent/tombstone, -1 error. *val is malloc'd.
int lsm_get(void* db, const uint8_t* key, uint32_t klen, int64_t limit,
            uint8_t** val, uint64_t* vlen) {
  std::string out;
  int r = static_cast<LsmDb*>(db)->get(
      std::string(reinterpret_cast<const char*>(key), klen), limit, &out);
  if (r == 0) {
    *val = static_cast<uint8_t*>(std::malloc(out.size() ? out.size() : 1));
    std::memcpy(*val, out.data(), out.size());
    *vlen = out.size();
    return 0;
  }
  *val = nullptr;
  *vlen = 0;
  return r < 0 ? -1 : 1;
}

// buf = batch payload (same format as WAL): u32 count, then ops.
int lsm_write_batch(void* db, const uint8_t* buf, uint64_t buflen,
                    char** err) {
  std::vector<Op> ops;
  if (!parse_payload(buf, buflen, &ops)) {
    set_err("malformed batch", err);
    return -1;
  }
  std::string e;
  int r = static_cast<LsmDb*>(db)->write_batch(ops, &e);
  if (r != 0) set_err(e, err);
  return r;
}

int lsm_flush(void* db, char** err) {
  std::string e;
  if (!static_cast<LsmDb*>(db)->flush(&e)) {
    set_err(e, err);
    return -1;
  }
  return 0;
}

int lsm_compact(void* db, char** err) {
  std::string e;
  if (!static_cast<LsmDb*>(db)->compact(&e)) {
    set_err(e, err);
    return -1;
  }
  return 0;
}

// *out = malloc'd concatenation of [u32 klen][key] for live keys under prefix.
int lsm_scan_prefix(void* db, const uint8_t* prefix, uint32_t plen,
                    uint8_t** out, uint64_t* outlen) {
  std::string buf;
  static_cast<LsmDb*>(db)->scan_prefix(
      std::string(reinterpret_cast<const char*>(prefix), plen), &buf);
  *out = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
  std::memcpy(*out, buf.data(), buf.size());
  *outlen = buf.size();
  return 0;
}

uint64_t lsm_stat(void* db, int what) {
  return static_cast<LsmDb*>(db)->stat(what);
}

void lsm_set_mem_limit(void* db, uint64_t bytes) {
  static_cast<LsmDb*>(db)->set_mem_limit(bytes);
}

void lsm_free(uint8_t* p) { std::free(p); }

}  // extern "C"
